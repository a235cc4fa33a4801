"""The MEMO-TPU index: an HBM-friendly sorted struct-of-arrays interval store.

Replaces the reference's on-disk BED -> ZSTD Parquet index
(reference parquet_compress_bed.py:16-39) with in-memory int arrays sorted by
(record, start), ready to be placed on device. Window extraction becomes a
``searchsorted`` over a composite (record, start) key instead of Parquet
predicate pushdown (reference memo_query.py:19-36).

Compat importers/exporters for the reference's BED and Parquet formats are in
:mod:`memo_tpu_torch.io.compat` — this module is the native format (.npz).
A loaded store reads its four large columns from the file only when host
code first uses one (:mod:`memo_tpu_torch.index.npz`), so a placement can
stream them from the file to the device without a host copy.

The port's own copy of :mod:`memo_tpu.index.store`, which stays the reference; the two
read and write the same files.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np

from memo_tpu_torch.index.npz import NpzMembers

_MAGIC = "memo-tpu-interval-store-v1"
# The large columns, with their dtypes; a loaded store reads each on first use.
COLUMNS = {"rec_id": np.int32, "start": np.int64, "end": np.int64, "order": np.int32}


@dataclass
class IntervalStore:
    """Sorted MEM-overlap interval index over a pivot genome.

    ``kind`` is "conservation" (order-MEMs, reference index.sh:96-102) or
    "membership" (per-document MEMs, index.sh:88-93). ``order`` columns are
    1-based: document j+1 for membership, j-th largest MS for conservation.
    """

    record_names: list[str]
    record_lens: np.ndarray  # int64[R]
    n_docs: int  # total genomes in the pangenome INCLUDING the pivot
    kind: str  # "conservation" | "membership"
    rec_id: np.ndarray  # int32[M]
    start: np.ndarray  # int64[M]  (BED f1)
    end: np.ndarray  # int64[M]  (BED f2)
    order: np.ndarray  # int32[M] (BED f3)
    rec_offsets: np.ndarray = field(default=None)  # int64[R+1]
    max_interval_len: np.ndarray = field(default=None)  # int64[R]

    def __post_init__(self):
        self.record_lens = np.asarray(self.record_lens, np.int64)
        for name, dtype in COLUMNS.items():
            if name in self.__dict__:  # else still in the file (``load``)
                setattr(self, name, np.asarray(self.__dict__[name], dtype))
        if self.rec_offsets is None:
            self.rec_offsets = self._compute_offsets()
        else:
            self.rec_offsets = np.asarray(self.rec_offsets, np.int64)
        if self.max_interval_len is None:
            self.max_interval_len = self._compute_max_len()
        else:
            self.max_interval_len = np.asarray(self.max_interval_len, np.int64)

    def __getattr__(self, name: str):
        """A column of a loaded store that no host code has used yet: read
        from its file now, and kept."""
        npz = self.__dict__.get("_npz")
        if name not in COLUMNS or npz is None:
            raise AttributeError(f"{type(self).__name__!r} object has no attribute {name!r}")
        value = np.asarray(npz.read(name), COLUMNS[name])
        setattr(self, name, value)
        return value

    # ------------------------------------------------------------------ core
    @property
    def num_records(self) -> int:
        return len(self.record_names)

    @property
    def num_intervals(self) -> int:
        npz = self.__dict__.get("_npz")
        if "start" not in self.__dict__ and npz is not None and npz.member("start").direct:
            return int(npz.member("start").shape[0])
        return int(self.start.shape[0])

    def file_columns(self) -> tuple[NpzMembers | None, list[str]]:
        """The member table of the file this store was loaded from (None for
        a store built in memory), and the columns still only there: those no
        host code has read or set."""
        npz = self.__dict__.get("_npz")
        return npz, [n for n in COLUMNS if npz is not None and n not in self.__dict__]

    def _compute_offsets(self) -> np.ndarray:
        counts = np.bincount(self.rec_id, minlength=self.num_records)
        return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)

    def _compute_max_len(self) -> np.ndarray:
        out = np.zeros(self.num_records, np.int64)
        lens = self.end - self.start
        for r in range(self.num_records):
            lo, hi = self.rec_offsets[r], self.rec_offsets[r + 1]
            if hi > lo:
                out[r] = lens[lo:hi].max()
        return out

    def record_index(self, name: str) -> int:
        try:
            return self.record_names.index(name)
        except ValueError:
            raise KeyError(f"record {name!r} not in index ({self.record_names})") from None

    def query_layout(self) -> "QueryLayout":
        """Pre-sorted event layout for the fused Pallas query path (computed
        once, cached). See ops/pallas_query.py for why these orders exist."""
        lay = getattr(self, "_query_layout", None)
        if lay is None:
            lay = QueryLayout.build(self)
            self._query_layout = lay
        return lay

    def window_bounds(self, record: str, qs: int, qe: int, k: int) -> tuple[int, int]:
        """Row range [lo, hi) guaranteed to contain every interval relevant to
        query window [qs, qe) at k-mer size k.

        The reference's Parquet filters select rows with
        (f1<=qs & f2>qs) | (qs<f1<qe+k) (memo_query.py:22-28). Any superset is
        output-equivalent because out-of-window rows clip to empty
        (memo_query.py:46-49) — so we take f1 in [qs - max_interval_len, qe+k),
        a contiguous run of the sorted store found by binary search.
        """
        r = self.record_index(record)
        lo0, hi0 = int(self.rec_offsets[r]), int(self.rec_offsets[r + 1])
        seg = self.start[lo0:hi0]
        lo = lo0 + int(np.searchsorted(seg, qs - int(self.max_interval_len[r]), side="left"))
        hi = lo0 + int(np.searchsorted(seg, qe + k, side="left"))
        return lo, hi

    # ------------------------------------------------------------- serialization
    def save(self, path: str | os.PathLike, compressed: bool = True) -> None:
        """Write the store as .npz; ``compressed=False`` skips zlib (fast for
        stores of tens of millions of rows)."""
        meta = {
            "magic": _MAGIC,
            "record_names": self.record_names,
            "n_docs": self.n_docs,
            "kind": self.kind,
        }
        (np.savez_compressed if compressed else np.savez)(
            path,
            meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
            record_lens=self.record_lens,
            rec_id=self.rec_id,
            start=self.start,
            end=self.end,
            order=self.order,
            rec_offsets=self.rec_offsets,
            max_interval_len=self.max_interval_len,
        )

    @classmethod
    def load(cls, path: str | os.PathLike) -> "IntervalStore":
        """The store saved at ``path``, equal to ``np.load``'s reading of it
        (memo_tpu's ``load``). Reads the member table and the small members;
        each large column is read from the file on first use (or streamed
        to a device by ``index/placement.upload_columns``)."""
        npz = NpzMembers(path)
        meta = json.loads(npz.read("meta").tobytes().decode())
        if meta.get("magic") != _MAGIC:
            raise ValueError(f"{path}: not a memo-tpu interval store")
        store = cls.__new__(cls)
        store._npz = npz
        store.record_names = list(meta["record_names"])
        store.record_lens = npz.read("record_lens")
        store.n_docs = int(meta["n_docs"])
        store.kind = meta["kind"]
        for name in COLUMNS:
            npz.member(name)  # a missing column raises KeyError now, as np.load's reads do
        store.rec_offsets = npz.read("rec_offsets")
        store.max_interval_len = npz.read("max_interval_len")
        store.__post_init__()
        return store

    # ------------------------------------------------------------------ misc
    def stats(self) -> dict:
        return {
            "records": self.num_records,
            "intervals": self.num_intervals,
            "n_docs": self.n_docs,
            "kind": self.kind,
            "bytes": int(
                self.rec_id.nbytes + self.start.nbytes + self.end.nbytes + self.order.nbytes
            ),
        }

@dataclass
class QueryLayout:
    """Pre-sorted event views of an IntervalStore for the fused query kernel.

    Query-time shadow casting (st = start − qs, ce = end − qs − (k−1),
    reference memo_query.py:46-47) is rank-preserving in ``start`` and
    ``end``, so sorting once here means NO per-query sort:

    - ``end order`` (record-major): the +1 event stream of every query.
      The store's native (record, start) order is already the −1 stream.
    - ``column segments``: rows regrouped by (record, order) and sorted by
      start — used to count out-of-window intervals (the query's coverage
      at window position 0) with two searchsorteds per column. That count
      formula needs starts AND ends jointly nondecreasing per column, which
      holds for true matching statistics (MS drops by ≤1 per position, so
      MEM ends are nondecreasing — and so are consecutive-overlap ends);
      ``monotone`` records whether this store satisfies it, else
      prefix_counts falls back to a vectorized scan.
    """

    end_sorted: np.ndarray  # int64[M] ends, sorted within each record
    start_by_end: np.ndarray  # int64[M] partner starts, aligned to end_sorted
    order_by_end: np.ndarray  # int32[M]
    s_by_col: np.ndarray  # int64[M] starts, grouped by (record, order)
    e_by_col: np.ndarray  # int64[M] partner ends
    col_offsets: np.ndarray  # int64[R*C + 1] flattened (record, order) segments
    monotone: bool
    # Composite keys seg_id*stride + value: globally sorted, so per-segment
    # searchsorted vectorizes into ONE searchsorted over all C columns at
    # once (prefix_counts) instead of a per-column Python loop.
    key_stride: int = 0
    s_keys: np.ndarray = None  # int64[M]
    e_keys: np.ndarray = None  # int64[M]

    @classmethod
    def build(cls, store: "IntervalStore") -> "QueryLayout":
        C = store.n_docs
        rec = store.rec_id.astype(np.int64)
        perm_e = np.lexsort((store.end, rec))
        in_range = bool(np.all((store.order >= 0) & (store.order < C))) if store.num_intervals else True

        if in_range:
            key = rec * C + store.order
            perm_c = np.lexsort((store.start, key))
            s_by_col = store.start[perm_c]
            e_by_col = store.end[perm_c]
            counts = np.bincount(key, minlength=store.num_records * C)
            col_offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
            # Joint monotonicity of ends within each (record, order) segment
            # (starts are sorted by construction).
            nondec = np.ones(store.num_intervals, bool)
            if store.num_intervals > 1:
                nondec[1:] = e_by_col[1:] >= e_by_col[:-1]
                # Segment starts are exempt; empty trailing segments have
                # offset == M (nothing to exempt there).
                seg_starts = col_offsets[1:-1]
                nondec[seg_starts[seg_starts < store.num_intervals]] = True
            monotone = bool(nondec.all())
        else:  # foreign index with out-of-range orders: scan fallback only
            s_by_col = np.zeros(0, np.int64)
            e_by_col = np.zeros(0, np.int64)
            col_offsets = np.zeros(store.num_records * C + 1, np.int64)
            monotone = False

        if in_range and store.num_intervals:
            # Stride must exceed every stored coordinate (ends can reach 2L).
            stride = int(max(store.end.max(), store.start.max())) + 2
            seg_of_row = np.repeat(
                np.arange(len(col_offsets) - 1, dtype=np.int64),
                np.diff(col_offsets),
            )
            s_keys = seg_of_row * stride + s_by_col
            e_keys = seg_of_row * stride + e_by_col
        else:
            stride, s_keys, e_keys = 1, np.zeros(0, np.int64), np.zeros(0, np.int64)

        return cls(
            end_sorted=store.end[perm_e],
            start_by_end=store.start[perm_e],
            order_by_end=store.order[perm_e],
            s_by_col=s_by_col,
            e_by_col=e_by_col,
            col_offsets=col_offsets,
            monotone=monotone,
            key_stride=stride,
            s_keys=s_keys,
            e_keys=e_keys,
        )

    def prefix_counts(self, store: "IntervalStore", r: int, qs: int, k: int) -> np.ndarray:
        """int64[C] per-column count of intervals marking window position 0:
        ``#{i in record r, order c: end_i <= qs+k-1 < ... and start_i > qs}``
        — the coverage carried into the window from its left (see
        ops/pallas_query.py docstring, observation 2)."""
        C = store.n_docs
        E0 = qs + k - 1
        out = np.zeros(C, np.int64)
        if self.monotone:
            # One vectorized searchsorted per stream over ALL columns of this
            # record at once (composite seg*stride+value keys are globally
            # sorted), instead of 2(C-1) tiny per-column searches.
            segs = np.arange(r * C + 1, r * C + C, dtype=np.int64)
            # Clamp probes into this segment's key range: stride exceeds every
            # stored value, so stride-1 means "count all" (k can push E0 past
            # it on tiny records) and qs >= 0 is already in range.
            e_probe = min(E0, self.key_stride - 1)
            pe = np.searchsorted(self.e_keys, segs * self.key_stride + e_probe, side="right")
            ps = np.searchsorted(self.s_keys, segs * self.key_stride + qs, side="right")
            np.maximum(pe - ps, 0, out=out[1:])
            return out
        lo, hi = store.rec_offsets[r], store.rec_offsets[r + 1]
        mask = (store.end[lo:hi] <= E0) & (store.start[lo:hi] > qs)
        o = store.order[lo:hi][mask]
        o = o[(o >= 0) & (o < C)]
        return np.bincount(o, minlength=C)[:C].astype(np.int64)
