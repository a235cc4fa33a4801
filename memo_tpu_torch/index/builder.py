"""Index construction pipeline: genome list -> IntervalStore.

The TPU-native replacement for the reference's bash orchestration
(reference index.sh): no per-stage text files — FASTA records go straight
through the in-repo matching-statistics engine into dense int32 MS arrays,
then through vectorized MEM/overlap extraction into the sorted interval
store. ``--emit-compat`` reproduces the reference's on-disk artifacts
(PIVOT.fai, dap.txt, prefix.bed, prefix.parquet) byte-for-byte for parity
checks and interop.

Failure recovery (SURVEY §5): per-document MS arrays are content-hash cached
in the work directory; a crashed build resumes by skipping finished
documents — per-document builds are embarrassingly parallel and
independently restartable, like the reference's per-genome artifacts but
formalized with a manifest.

The port's own copy of :mod:`memo_tpu.index.builder`, which stays the reference; the two
read and write the same files.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass

import numpy as np

from memo_tpu_torch.index.intervals import mem_overlap_intervals
from memo_tpu_torch.index.ms import document_ms
from memo_tpu_torch.index.store import IntervalStore
from memo_tpu_torch.io.fasta import read_fasta, write_fai
from memo_tpu_torch.utils.logging import get_logger
from memo_tpu_torch.utils.profiling import stage_timer

log = get_logger(__name__)


def _file_sha(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for block in iter(lambda: fh.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()[:24]


@dataclass
class BuildConfig:
    kind: str = "conservation"  # or "membership" (reference index.sh -m flag)
    backend: str = "auto"  # MS backend: auto | native | python | sa
    ms_budget_bytes: int | None = None  # RAM budget per MS group build
    uppercase: bool = True
    workdir: str | None = None  # MS cache location (None = no caching)
    emit_compat: bool = False  # also write fai/dap.txt/bed/parquet
    compat_prefix: str | None = None
    jobs: int = 1  # parallel per-document MS builds (ctypes releases the GIL)
    # Pooled colored-GSA MS (memo_tpu_torch.index.ms.pangenome_ms): one suffix
    # array per RAM-budget group SHARED by every document inside it, instead
    # of one per document — the pivot is sorted once per group and forward-
    # only indexing halves the document chars again. None = auto: pool when
    # the estimated SA-IS char count drops below ~60% of the per-document
    # path's (always true at HPRC-like widths, rarely for 2-3 huge docs).
    pooled: bool | None = None


def read_genome_list(path: str) -> list[str]:
    """One genome path per line, first line = pivot (reference index.sh:55)."""
    base = os.path.dirname(os.path.abspath(path))
    out = []
    with open(path) as fh:
        for line in fh:
            p = line.strip()
            if p:
                out.append(p if os.path.isabs(p) else os.path.join(base, p))
    if len(out) < 2:
        raise ValueError(f"{path}: need a pivot and at least one other genome")
    return out


def _ms_for_document(
    doc_path: str, pivot_records, pivot_sha: str, cfg: BuildConfig, inner_jobs: int = 1
) -> list[np.ndarray]:
    """MS of every pivot record vs one document, with manifest caching.
    ``inner_jobs`` threads parallelize the within-document MS groups when the
    document itself is the unit of work (single-document builds)."""
    cache_path = None
    if cfg.workdir:
        os.makedirs(cfg.workdir, exist_ok=True)
        key = f"{_file_sha(doc_path)}-{pivot_sha}-{int(cfg.uppercase)}"
        cache_path = os.path.join(cfg.workdir, f"ms-{key}.npz")
        if os.path.exists(cache_path):
            log.info("MS cache hit for %s", os.path.basename(doc_path))
            with np.load(cache_path) as z:
                return [z[f"r{i}"] for i in range(len(pivot_records))]

    doc_records = read_fasta(doc_path)
    if cfg.uppercase:
        doc_records = [r.upper() for r in doc_records]
    with stage_timer(f"ms:{os.path.basename(doc_path)}"):
        cols = document_ms(
            pivot_records,
            doc_records,
            backend=cfg.backend,
            budget_bytes=cfg.ms_budget_bytes,
            jobs=inner_jobs,
        )
    log.info(
        "computed MS for %s (%d records, backend=%s)",
        os.path.basename(doc_path),
        len(doc_records),
        cfg.backend,
    )

    if cache_path:
        tmp = cache_path + ".tmp.npz"  # .npz suffix so savez doesn't append one
        np.savez_compressed(tmp, **{f"r{i}": c for i, c in enumerate(cols)})
        os.replace(tmp, cache_path)
    return cols


def _pooled_ms(
    doc_paths: list[str], pivot_records, pivot_sha: str, cfg: BuildConfig
) -> list[list[np.ndarray]]:
    """MS for all documents via pooled colored-GSA groups
    (:func:`memo_tpu_torch.index.ms.pangenome_ms`), honoring and writing the SAME
    per-document cache entries as the per-document path — pooled and
    per-document builds share resume state."""
    from memo_tpu_torch.index.ms import pangenome_ms

    by_doc: dict[int, list[np.ndarray]] = {}
    cache_paths: dict[int, str] = {}
    to_build: list[int] = []
    for j, p in enumerate(doc_paths):
        if cfg.workdir:
            os.makedirs(cfg.workdir, exist_ok=True)
            key = f"{_file_sha(p)}-{pivot_sha}-{int(cfg.uppercase)}"
            cache_paths[j] = os.path.join(cfg.workdir, f"ms-{key}.npz")
            if os.path.exists(cache_paths[j]):
                log.info("MS cache hit for %s", os.path.basename(p))
                with np.load(cache_paths[j]) as z:
                    by_doc[j] = [z[f"r{i}"] for i in range(len(pivot_records))]
                continue
        to_build.append(j)
    if to_build:
        docs = []
        for j in to_build:
            recs = read_fasta(doc_paths[j])
            docs.append([r.upper() for r in recs] if cfg.uppercase else recs)
        with stage_timer(f"ms:pooled[{len(to_build)}docs]"):
            built = pangenome_ms(
                pivot_records,
                docs,
                budget_bytes=cfg.ms_budget_bytes,
                jobs=cfg.jobs,
            )
        for j, cols in zip(to_build, built):
            by_doc[j] = cols
            if cfg.workdir:
                tmp = cache_paths[j] + ".tmp.npz"
                np.savez_compressed(tmp, **{f"r{i}": c for i, c in enumerate(cols)})
                os.replace(tmp, cache_paths[j])
        log.info(
            "computed pooled MS for %d documents (GSA groups, jobs=%d)",
            len(to_build),
            cfg.jobs,
        )
    return [by_doc[j] for j in range(len(doc_paths))]


def _auto_pooled(doc_paths: list[str], pivot_chars: int, cfg: BuildConfig) -> bool:
    """Estimate whether pooled colored-GSA groups beat per-document suffix
    arrays, by total SA-IS chars (file sizes proxy sequence lengths):

    - per-document: each doc sorts (2*D_j + P) chars (doc+RC text, pivot
      re-queried per doc);
    - pooled fwd-only: D_total doc chars total + 2*P query chars per group
      (P and RC(P) both queried in the forward-only layout).

    Pool when the pooled estimate is < 45% of per-document. The margin is
    CALIBRATED (r5, tools/bench_pooled_calib.py on an idle host, medians of
    3, docs/POOLED_CALIB_r05.json): a pooled char costs ~1.8-2.0x a
    per-document char (colored-GSA build = SA-IS + Kasai LCP + color table
    vs plain automaton/SA; plus per-color scan passes), consistently at 6-
    and 33-doc widths — so pooling wins wall-clock only when the char model
    predicts <~0.48x, and 0.45 adds slack. At the bench pangenome shape
    (33 x 1 Mbp, model 0.37) pooling measures 1.51x; at 6 x 1 Mbp (model
    0.56) it measures 0.92x and now correctly disengages. The r4 bench
    artifact's pooled 0.9x AT the 33-doc shape was main-process CPU
    contention — the pangenome A/B now runs in an isolated stage child
    like every other device stage (bench.py --stage-index)."""
    from memo_tpu_torch.index.ms import _ms_budget_bytes, gsa_group_cap

    if cfg.backend not in ("auto", "sa") or len(doc_paths) < 3:
        return False
    from memo_tpu_torch.native.build import load_libms

    if load_libms() is None:
        return False
    try:
        d_sizes = [os.path.getsize(p) for p in doc_paths]
    except OSError:
        return False
    d_total = sum(d_sizes)
    budget = _ms_budget_bytes(cfg.ms_budget_bytes)
    q_chars = 2 * pivot_chars  # P and RC(P) both queried in the fwd layout
    # Group cap: the SAME expression pangenome_ms will use (shared helper —
    # the r4 advisor found a drifted local copy here doubled the group-count
    # estimate), then the jobs spread it also applies.
    group_max = gsa_group_cap(budget, q_chars)
    if cfg.jobs > 1:
        group_max = min(group_max, max((d_total + cfg.jobs - 1) // cfg.jobs, 1 << 20))
    n_groups = max((d_total + group_max - 1) // group_max, 1)
    if d_total > budget // 2:
        # The pooled path materializes every uncached document's records in
        # RAM at once (pangenome_ms's contract); the per-document path
        # streams one document at a time. Stay per-document when the inputs
        # alone would eat half the MS budget.
        return False
    pooled_chars = d_total + n_groups * q_chars
    per_doc_chars = 2 * d_total + len(doc_paths) * pivot_chars
    return pooled_chars < 0.45 * per_doc_chars


def build_index(genome_list: list[str] | str, cfg: BuildConfig | None = None) -> IntervalStore:
    cfg = cfg or BuildConfig()
    if isinstance(genome_list, str):
        genome_list = read_genome_list(genome_list)
    pivot_path, doc_paths = genome_list[0], genome_list[1:]
    n_docs = len(genome_list)  # total genomes incl. pivot (query.sh -n)

    pivot_records = read_fasta(pivot_path)
    if cfg.uppercase:
        pivot_records = [r.upper() for r in pivot_records]
    pivot_sha = _file_sha(pivot_path)

    # DAP assembly: column j = document j in list order (reference index.sh:83).
    # Per-document builds are independent (reference index.sh:59-80 runs them
    # sequentially); the C++ MS engine releases the GIL, so threads scale.
    pivot_chars = sum(len(r) + 1 for r in pivot_records)
    pooled = (
        cfg.pooled
        if cfg.pooled is not None
        else _auto_pooled(doc_paths, pivot_chars, cfg)
    )
    if pooled:
        cols_by_doc = _pooled_ms(doc_paths, pivot_records, pivot_sha, cfg)
    elif cfg.jobs > 1 and len(doc_paths) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=cfg.jobs) as pool:
            cols_by_doc = list(
                pool.map(
                    lambda p: _ms_for_document(p, pivot_records, pivot_sha, cfg),
                    doc_paths,
                )
            )
    else:
        # Serial over documents: spend the job budget inside each document
        # (parallel MS groups) instead — the single-chromosome build case.
        cols_by_doc = [
            _ms_for_document(p, pivot_records, pivot_sha, cfg, inner_jobs=cfg.jobs)
            for p in doc_paths
        ]

    # The store is extracted straight from the per-document columns in
    # streamed row chunks — the row-major [P, D] DAP matrix (46 GB at
    # 128 Mbp x 90 docs) is materialized ONLY for the compat artifacts.
    store = store_from_doc_columns(
        cols_by_doc,
        record_names=[r.name for r in pivot_records],
        record_lens=[len(r) for r in pivot_records],
        n_docs=n_docs,
        kind=cfg.kind,
    )

    if cfg.emit_compat:
        ms_by_record = [
            np.zeros((len(r), len(doc_paths)), np.int32) for r in pivot_records
        ]
        for j, cols in enumerate(cols_by_doc):
            for i, col in enumerate(cols):
                ms_by_record[i][:, j] = col
        emit_compat_artifacts(store, ms_by_record, pivot_path, cfg)
    return store


def store_from_doc_columns(
    cols_by_doc: list[list[np.ndarray]],
    record_names: list[str],
    record_lens: list[int],
    n_docs: int,
    kind: str,
    chunk_rows: int = 1 << 22,
) -> IntervalStore:
    """Per-document MS columns -> sorted overlap-interval store, streaming
    row chunks through the carry-chunked extractor
    (:class:`memo_tpu_torch.index.intervals.StreamingOverlapExtractor`) — the
    row-major DAP never materializes, which is what makes the combined
    chromosome x pangenome build (128 Mbp x 90 docs, a ~46 GB DAP) fit in
    RAM alongside the columns themselves."""
    from memo_tpu_torch.index.intervals import StreamingOverlapExtractor

    order_sort = kind == "conservation"
    D = len(cols_by_doc)
    rec_ids, starts, ends, orders = [], [], [], []
    for r, name in enumerate(record_names):
        L = int(record_lens[r])
        with stage_timer(f"intervals:{name}"):
            ex = StreamingOverlapExtractor(D, L, order_sort=order_sort)
            parts_s, parts_e, parts_o = [], [], []
            buf = np.empty((min(chunk_rows, max(L, 1)), D), np.int32)
            for lo in range(0, L, chunk_rows):
                hi = min(lo + chunk_rows, L)
                chunk = buf[: hi - lo]
                for j in range(D):
                    chunk[:, j] = cols_by_doc[j][r][lo:hi]
                s, e, o = ex.feed(chunk)
                parts_s.append(s)
                parts_e.append(e)
                parts_o.append(o)
            s, e, o = ex.finish()
            parts_s.append(s)
            parts_e.append(e)
            parts_o.append(o)
        n_iv = sum(p.shape[0] for p in parts_s)
        rec_ids.append(np.full(n_iv, r, np.int32))
        starts.append(np.concatenate(parts_s) if parts_s else np.zeros(0, np.int64))
        ends.append(np.concatenate(parts_e) if parts_e else np.zeros(0, np.int64))
        orders.append(np.concatenate(parts_o) if parts_o else np.zeros(0, np.int64))
    store = IntervalStore(
        record_names=list(record_names),
        record_lens=np.asarray(record_lens, np.int64),
        n_docs=n_docs,
        kind=kind,
        rec_id=np.concatenate(rec_ids) if rec_ids else np.zeros(0, np.int32),
        start=np.concatenate(starts) if starts else np.zeros(0, np.int64),
        end=np.concatenate(ends) if ends else np.zeros(0, np.int64),
        order=np.concatenate(orders) if orders else np.zeros(0, np.int64),
    )
    log.info("built %s index: %s", kind, store.stats())
    return store


def store_from_ms(
    ms_by_record: list[np.ndarray],
    record_names: list[str],
    record_lens: list[int],
    n_docs: int,
    kind: str,
) -> IntervalStore:
    """MS arrays -> sorted overlap-interval store (the DAP -> BED stage,
    reference dap_to_bed.py, vectorized)."""
    order_sort = kind == "conservation"
    rec_ids, starts, ends, orders = [], [], [], []
    for r, ms in enumerate(ms_by_record):
        with stage_timer(f"intervals:{record_names[r]}"):
            s, e, o = mem_overlap_intervals(ms, record_lens[r], order_sort=order_sort)
        rec_ids.append(np.full(s.shape[0], r, np.int32))
        starts.append(s)
        ends.append(e)
        orders.append(o)
    store = IntervalStore(
        record_names=list(record_names),
        record_lens=np.asarray(record_lens, np.int64),
        n_docs=n_docs,
        kind=kind,
        rec_id=np.concatenate(rec_ids) if rec_ids else np.zeros(0, np.int32),
        start=np.concatenate(starts) if starts else np.zeros(0, np.int64),
        end=np.concatenate(ends) if ends else np.zeros(0, np.int64),
        order=np.concatenate(orders) if orders else np.zeros(0, np.int64),
    )
    log.info("built %s index: %s", kind, store.stats())
    return store


def emit_compat_artifacts(
    store: IntervalStore, ms_by_record: list[np.ndarray], pivot_path: str, cfg: BuildConfig
) -> None:
    """Write the reference's on-disk artifact chain (index.sh:56,83,86-109)."""
    from memo_tpu_torch.io import compat

    outdir = cfg.workdir or "."
    os.makedirs(outdir, exist_ok=True)
    prefix = cfg.compat_prefix or "memo"
    write_fai(pivot_path)
    compat.write_dap_text(ms_by_record, os.path.join(outdir, "dap.txt"))
    compat.write_bed(store, os.path.join(outdir, f"{prefix}.bed"))
    compat.write_parquet(store, os.path.join(outdir, f"{prefix}.parquet"))
    manifest = {
        "pivot": os.path.abspath(pivot_path),
        "kind": store.kind,
        "n_docs": store.n_docs,
        "records": dict(zip(store.record_names, store.record_lens.tolist())),
        "intervals": store.num_intervals,
    }
    with open(os.path.join(outdir, f"{prefix}.manifest.json"), "w") as fh:
        json.dump(manifest, fh, indent=2)
