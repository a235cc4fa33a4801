"""Reference-format compatibility: BED text and ZSTD Parquet index files.

The native index format is :class:`memo_tpu_torch.index.store.IntervalStore` (.npz);
these importers/exporters interoperate with indexes produced by the reference
pipeline (reference index.sh:86-109, parquet_compress_bed.py:16-39), so a
reference user can bring their existing .bed/.parquet index.

The port's own copy of :mod:`memo_tpu.io.compat`, which stays the reference; the two
read and write the same files.
"""

from __future__ import annotations

import os
from typing import IO

import numpy as np

from memo_tpu_torch.index.store import IntervalStore


def write_bed(store: IntervalStore, path_or_file: str | os.PathLike | IO[bytes]) -> None:
    """Write the store as reference-identical BED text: one
    ``name\\tstart\\tend\\torder`` line per interval in emission order
    (reference dap_to_bed.py:104, '\\t'.join)."""
    own = not hasattr(path_or_file, "write")
    out = open(path_or_file, "wb") if own else path_or_file
    try:
        for r in range(store.num_records):
            lo, hi = store.rec_offsets[r], store.rec_offsets[r + 1]
            if hi == lo:
                continue
            name = store.record_names[r].encode()
            block = np.stack(
                [store.start[lo:hi], store.end[lo:hi], store.order[lo:hi].astype(np.int64)],
                axis=1,
            )
            lines = b"\n".join(
                name + b"\t" + b"\t".join(str(v).encode() for v in row) for row in block.tolist()
            )
            out.write(lines + b"\n")
    finally:
        if own:
            out.close()


def write_parquet(
    store: IntervalStore,
    path: str | os.PathLike,
    codec: str = "ZSTD",
    block_bytes: int = 500_000_000,
    one_shot: bool = False,
) -> None:
    """Write the reference Parquet schema: f0 utf8, f1/f2/f3 int64, ZSTD
    (reference parquet_compress_bed.py:21-26).

    Streams one row group per ~``block_bytes`` of BED-text-equivalent rows —
    the reference's 500 MB CSV block streaming (parquet_compress_bed.py:16-39)
    — so chromosome-scale indexes never materialize a whole Arrow table.
    ``one_shot=True`` mirrors the reference's ``-a`` flag (compress_bed_all,
    :42-46): a single row group.
    """
    import pyarrow as pa
    import pyarrow.parquet as pq

    schema = pa.schema(
        [("f0", pa.utf8()), ("f1", pa.int64()), ("f2", pa.int64()), ("f3", pa.int64())]
    )
    M = store.num_intervals
    name_arr = np.array(store.record_names, dtype=object)
    # Rows per block sized like the reference's CSV blocks: estimate the
    # BED-text bytes of one row (name + 3 ints + separators) from a sample.
    if one_shot or M == 0:
        rows_per_block = max(M, 1)
    else:
        sample = slice(0, min(M, 4096))
        text_bytes = sum(
            len(store.record_names[r]) + len(str(s)) + len(str(e)) + len(str(o)) + 4
            for r, s, e, o in zip(
                store.rec_id[sample],
                store.start[sample],
                store.end[sample],
                store.order[sample],
            )
        )
        avg = max(text_bytes / max(sample.stop, 1), 1.0)
        rows_per_block = max(int(block_bytes / avg), 1)

    with pq.ParquetWriter(str(path), schema, compression=codec) as writer:
        for lo in range(0, max(M, 1), rows_per_block):
            hi = min(lo + rows_per_block, M)
            block = pa.table(
                {
                    "f0": pa.array(name_arr[store.rec_id[lo:hi]], type=pa.utf8()),
                    "f1": pa.array(store.start[lo:hi], type=pa.int64()),
                    "f2": pa.array(store.end[lo:hi], type=pa.int64()),
                    "f3": pa.array(store.order[lo:hi].astype(np.int64), type=pa.int64()),
                },
                schema=schema,
            )
            writer.write_table(block)
            if M == 0:
                break


def _store_from_rows(
    names: np.ndarray, f1: np.ndarray, f2: np.ndarray, f3: np.ndarray, n_docs: int, kind: str
) -> IntervalStore:
    # Records appear contiguously in reference emission order; keep file order.
    record_names: list[str] = []
    rec_of_name: dict[str, int] = {}
    rec_id = np.empty(len(names), np.int32)
    for i, nm in enumerate(names):
        if nm not in rec_of_name:
            rec_of_name[nm] = len(record_names)
            record_names.append(nm)
        rec_id[i] = rec_of_name[nm]
    # Record length is only metadata for imports (query clipping uses the
    # region bounds, memo_query.py:44-48); the end-of-record sentinel rows
    # have start == record length, so max(start) recovers it when present.
    record_lens = np.zeros(len(record_names), np.int64)
    for r in range(len(record_names)):
        sel = rec_id == r
        if sel.any():
            record_lens[r] = f1[sel].max()
    return IntervalStore(
        record_names=record_names,
        record_lens=record_lens,
        n_docs=n_docs,
        kind=kind,
        rec_id=rec_id,
        start=f1.astype(np.int64),
        end=f2.astype(np.int64),
        order=f3.astype(np.int64),
    )


def read_parquet(
    path: str | os.PathLike, n_docs: int, kind: str, record: str | None = None
) -> IntervalStore:
    """Import a reference-produced Parquet index (schema f0..f3).

    ``record`` pushes an f0 == record predicate into the Parquet reader
    (row-group/page pruning) — the extract path's answer to the reference's
    tabix indexed random access: a single-window extract from a multi-GB
    index reads only that record's row groups."""
    import pyarrow.parquet as pq

    filters = [("f0", "==", record)] if record is not None else None
    t = pq.read_table(str(path), filters=filters)
    names = np.asarray(t.column("f0").to_pylist())
    f1 = np.asarray(t.column("f1"))
    f2 = np.asarray(t.column("f2"))
    f3 = np.asarray(t.column("f3"))
    return _store_from_rows(names, f1, f2, f3, n_docs, kind)


def read_bed(
    path: str | os.PathLike, n_docs: int, kind: str, record: str | None = None
) -> IntervalStore:
    """Import a reference-produced BED index. ``record`` filters rows while
    streaming (the extract path never holds unrelated records in memory)."""
    names: list[str] = []
    f1: list[int] = []
    f2: list[int] = []
    f3: list[int] = []
    with open(path) as fh:
        for line in fh:
            if not line.strip():
                continue
            a, b, c, d = line.rstrip("\n").split("\t")
            if record is not None and a != record:
                continue
            names.append(a)
            f1.append(int(b))
            f2.append(int(c))
            f3.append(int(d))
    return _store_from_rows(
        np.asarray(names), np.asarray(f1), np.asarray(f2), np.asarray(f3), n_docs, kind
    )


def extract_window(
    store: IntervalStore, record: str, qs: int, qe: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Legacy window extraction (reference extract.sh:61-63): the intervals of
    ``record`` fully contained in ``[qs, qe)``, in index order.

    The reference pipes ``tabix idx.bed.gz chr:s-e`` (overlapping rows) into
    ``bedtools intersect -sorted -wa -f 1`` (keep rows 100% inside the query
    window). For positive-length rows that composition is exactly
    ``qs <= start and end <= qe``. Zero-length bookend rows (start == end,
    SURVEY §2.3): htslib requires ``rec_beg < reg_end``, so a ``[qe, qe)``
    bookend is excluded here as tabix would; interior bookends are kept. A
    ``[qs, qs)`` bookend is kept — bedtools' zero-length expansion makes the
    reference's behavior at that edge ambiguous, so exact tabix|bedtools
    parity is claimed only away from the window start. Returns
    (starts, ends, orders).
    """
    r = store.record_index(record)
    lo0, hi0 = int(store.rec_offsets[r]), int(store.rec_offsets[r + 1])
    seg = store.start[lo0:hi0]
    lo = lo0 + int(np.searchsorted(seg, qs, side="left"))
    hi = lo0 + int(np.searchsorted(seg, qe, side="right"))
    s, e, o = store.start[lo:hi], store.end[lo:hi], store.order[lo:hi]
    keep = (e <= qe) & ~((s == e) & (s == qe))
    return s[keep], e[keep], o[keep]


def write_extracted_bed(
    store: IntervalStore, record: str, qs: int, qe: int, out_dir: str | os.PathLike
) -> str:
    """Write the extract.sh output file ``omem_olaps_{chr}_{s}_{e}.bed``
    (reference extract.sh:55) and return its path."""
    s, e, o = extract_window(store, record, qs, qe)
    path = os.path.join(str(out_dir), f"omem_olaps_{record}_{qs}_{qe}.bed")
    with open(path, "wb") as out:
        name = record.encode()
        for row in np.stack([s, e, o.astype(np.int64)], axis=1).tolist():
            out.write(name + b"\t" + b"\t".join(str(v).encode() for v in row) + b"\n")
    return path


def write_dap_text(ms_by_record: list[np.ndarray], path: str | os.PathLike) -> None:
    """Emit the reference dap.txt: ``pos ms_g2 ms_g3 ...`` single-space
    separated, global 0-based positions over the record concatenation
    (reference index.sh:83, paste|nl)."""
    with open(path, "w") as out:
        pos = 0
        for ms in ms_by_record:
            for row in ms.tolist():
                out.write(" ".join(map(str, [pos] + list(row))) + "\n")
                pos += 1


def read_dap_text(path: str | os.PathLike, record_lens: list[int]) -> list[np.ndarray]:
    """Parse a reference dap.txt back into per-record MS arrays."""
    rows: list[list[int]] = []
    with open(path) as fh:
        for line in fh:
            if line.strip():
                rows.append([int(x) for x in line.split(" ")[1:]])
    arr = np.asarray(rows, dtype=np.int64)
    out = []
    off = 0
    for L in record_lens:
        out.append(arr[off : off + L])
        off += L
    if off != arr.shape[0]:
        raise ValueError(f"dap has {arr.shape[0]} rows, record lens sum to {off}")
    return out
