"""Query orchestration on PyTorch: interval store -> device tensors ->
conservation/membership.

Counterpart of :mod:`memo_tpu.query.engine`, with the same contracts. The
store's columns go to the device once, and its length buckets and query
layout are built and kept there (:mod:`memo_tpu_torch.index.placement`);
then

1. the candidate row ranges and the prefix of the windows, searched on the
   device (:mod:`memo_tpu_torch.query.window`); the host reads back only
   each window's two candidate counts,
2. a device step per (window, interval bucket): the fused CUDA kernel
   (backend ``fused``; v1 and v2 both read the placed rows of the candidate
   ranges), or the diff-array tensor ops (backend ``torch``); ``numpy``
   runs on the host,
3. bit-exact text output (:mod:`memo_tpu_torch.query.output`).

Large windows run in position chunks and oversized candidate sets halve the
chunk, down to interval pieces combined with an elementwise minimum; dense
stores split into length buckets (the proofs are in the JAX engine's
docstrings and in memo_tpu/ops/query_ops.py). A batch of windows of one
record (``conservation_batch``/``membership_batch``) runs as one launch of
the kernel. PyTorch runs eagerly, so the pow2 candidate bucket M only
bounds the working set of one step (the fused kernels do not read it).
"""

from __future__ import annotations

import copy
import dataclasses
import os

import numpy as np
import torch

from memo_tpu_torch.index.placement import (
    Columns,
    PlacedStore,
    place_columns,
    place_store_and_layout,
    short_share,
    split_by_length,
    upload_columns,
)
from memo_tpu_torch.index.store import IntervalStore
from memo_tpu_torch.ops import query_ops as Q
from memo_tpu_torch.ops.fused_query import fused_query_rows
from memo_tpu_torch.ops.fused_query_v2 import ROW_SLACK, fused_query_v2_rows
from memo_tpu_torch.query.window import WindowParams, window_bounds, window_params
from memo_tpu_torch.utils.device import resolve_device
from memo_tpu_torch.utils.profiling import stage_timer

BACKENDS = ("fused", "torch", "numpy")
KERNEL_VERSIONS = ("v1", "v2")  # fused kernel generations, as memo_tpu names them


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


@dataclasses.dataclass
class QueryStats:
    """Per-query counters, as memo_tpu's engine keeps them."""

    candidate_intervals: int = 0
    chunks: int = 0
    positions: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def parse_region(region: str) -> tuple[str, int, int]:
    """Parse ``chr:start-end`` (0-indexed half-open, reference query.sh:24)."""
    record, _, start_end = region.rpartition(":")
    if not record:
        raise ValueError(f"bad region {region!r}, expected chr:start-end")
    start_s, _, end_s = start_end.partition("-")
    return record, int(start_s), int(end_s)


def place_store(store: IntervalStore, device, pad: int) -> PlacedStore:
    """An IntervalStore on ``device`` as six int32 tensors with ``pad``
    sentinel rows each, its end order sorted there
    (:func:`~memo_tpu_torch.index.placement.place_store_and_layout`)."""
    return place_store_and_layout(store, device, pad)[0]


class QueryEngine:
    """Arbitrary-k membership/conservation queries over an IntervalStore.

    backend:
      - "fused": the hand-written CUDA kernel (plain PyTorch on the CPU)
      - "torch": diff-array tensor ops on ``device``
      - "numpy": host fallback / cross-check
      - "auto": "fused"

    The positional parameters are memo_tpu's, in its order; ``device``
    (keyword only) is "cuda" or "cpu", and "cuda" raises where no GPU
    exists. The fused and torch backends place the store and build its
    query layout on ``device`` and search it there; the host keeps no copy
    of the placed rows (``store`` stays the caller's; queries read only its
    record names). ``device_output=True`` returns tensors on
    the device instead of numpy arrays. ``kernel_version`` picks the fused
    kernel: "v1" (``csrc/fused_query.cu``) or "v2"
    (``csrc/fused_query_v2.cu``), else ``$MEMO_TPU_PALLAS_KERNEL``, else
    "v1", as in memo_tpu.
    """

    def __init__(
        self,
        store: IntervalStore,
        backend: str = "auto",
        chunk_positions: int | None = None,
        max_intervals_per_chunk: int | None = None,
        device_output: bool = False,
        kernel_version: str | None = None,
        stratify: bool | str = "auto",
        *,
        device="cuda",
    ):
        if store.kind not in ("conservation", "membership"):
            raise ValueError(f"bad store kind {store.kind!r}")
        if backend == "auto":
            backend = "fused"
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        self.store = store
        self.backend = backend
        self.device = resolve_device(device)
        self.kernel_version = kernel_version or os.environ.get("MEMO_TPU_PALLAS_KERNEL") or "v1"
        if self.kernel_version not in KERNEL_VERSIONS:
            raise ValueError(f"unknown kernel_version {self.kernel_version!r}")
        # Large position chunks and interval buckets amortise per-step
        # overhead on the GPU; the CPU keeps small shapes for the tests.
        on_gpu = backend != "numpy" and self.device.type == "cuda"
        if chunk_positions is None:
            chunk_positions = (1 << 21) if on_gpu else (1 << 17)
        if max_intervals_per_chunk is None:
            max_intervals_per_chunk = (1 << 25) if on_gpu else (1 << 22)
        self.chunk_positions = int(chunk_positions)
        self.max_intervals = int(max_intervals_per_chunk)
        self.device_output = bool(device_output) and backend != "numpy"
        self.n_docs = store.n_docs
        self.last_stats = QueryStats()

        # Length stratification, with the JAX engine's gate (memo_tpu
        # engine.py:141-146) so both packages dispatch the same pieces: an
        # interval only marks when len < k-1, so a mostly-long store splits
        # into length buckets and a query skips buckets that cannot mark.
        self._children: list[tuple[int, QueryEngine]] | None = None
        if backend == "numpy":
            return
        cols = self._upload(store)
        if stratify == "auto":
            with stage_timer("engine.stratify_gate"):
                stratify = cols.start.numel() >= (1 << 20) and short_share(cols, 30) < 0.5
        if stratify:
            buckets = split_by_length(cols, self.STRATA_EDGES)
            del cols  # each bucket holds its own rows on the device
            self._init_stratified(buckets)
        else:
            self._place(cols)

    def _upload(self, store: IntervalStore) -> Columns:
        """The rows this engine places, on the device: the whole store. A
        subclass may return a subset of its rows (in store order) already
        there; the engine then answers over that subset, whose record
        offsets and longest intervals its layout holds."""
        return upload_columns(store, self.device)

    # Upper length bounds (exclusive) of the buckets: at k=31 only bucket 0
    # can mark (memo_tpu engine.py:187-191).
    STRATA_EDGES = (32, 128, 512, 2048)

    def _place(self, cols: Columns) -> None:
        # v2 reads rows in 16-byte copies, up to ROW_SLACK rows past a range.
        pad = max(min(self.max_intervals, _next_pow2(max(cols.start.numel(), 1))), ROW_SLACK + 1)
        self._d, self._layout = place_columns(cols, self.store.num_records, self.n_docs, pad)

    def _init_stratified(self, buckets: list[tuple[int, Columns]]) -> None:
        """One child engine per nonempty length bucket, placed from the
        bucket's rows on the device (its layout holds their record offsets
        and longest intervals; ``store`` is the parent's, shared); each child
        has the parent's settings, as in memo_tpu, and leaves its output on
        the device."""
        children: list[tuple[int, QueryEngine]] = []
        while buckets:  # popped, so each bucket's device columns go once it is placed
            b, sub_cols = buckets.pop(0)
            child = copy.copy(self)
            child.device_output = True
            child.last_stats = QueryStats()
            child._place(sub_cols)
            children.append((0 if b == 0 else self.STRATA_EDGES[b - 1], child))
        self._children = children

    def _query_stratified(self, record, qs, qe, k, membership):
        """Union of per-bucket marks == elementwise MIN of per-bucket outputs;
        buckets whose minimum length >= k-1 hold no live interval."""
        L = qe - qs
        n = self.n_docs
        stats = QueryStats(positions=L)
        acc = None
        for lb, child in self._children:
            if lb >= k - 1:
                continue
            out = child._query(record, qs, qe, k, membership)
            stats.candidate_intervals += child.last_stats.candidate_intervals
            stats.chunks += child.last_stats.chunks
            acc = out if acc is None else torch.minimum(acc, out)
        self.last_stats = stats
        if acc is None:  # k too small for any stored interval: nothing marks
            acc = self._unmarked((L,), membership)
        return acc if self.device_output else acc.cpu().numpy()

    def _unmarked(self, shape: tuple[int, ...], membership: bool) -> torch.Tensor:
        """The output of positions ``shape`` where nothing marks."""
        if membership:
            return torch.ones(shape + (self.n_docs,), dtype=torch.int8, device=self.device)
        return torch.full(shape, self.n_docs, dtype=torch.int32, device=self.device)

    # ------------------------------------------------------------------ public
    def conservation(self, record: str, qs: int, qe: int, k: int):
        """int array [qe-qs] of per-position conservation values in [0, n]."""
        return self._query(record, qs, qe, k, membership=False)

    def membership(self, record: str, qs: int, qe: int, k: int):
        """int8 array [qe-qs, n] presence/absence matrix (col 0 = pivot = 1)."""
        return self._query(record, qs, qe, k, membership=True)

    def query_region(self, region: str, k: int, membership: bool = False):
        record, qs, qe = parse_region(region)
        return self._query(record, qs, qe, k, membership=membership)

    def conservation_batch(self, record: str, windows, k: int) -> list:
        """Conservation of each window ``(qs, qe)`` of one record. On the
        ``fused`` backend the batch is one launch of the kernel: every
        window runs at the batch's longest length L from its own candidate
        ranges and prefix, and keeps its first ``qe - qs`` positions (exact:
        a window's row is what the single-window kernel computes over
        [qs, qs + L)). Windows longer than ``chunk_positions``, candidate sets
        over the bucket cap and the other backends run per window."""
        return self._query_batch(record, windows, k, membership=False)

    def membership_batch(self, record: str, windows, k: int) -> list:
        """Membership twin of :meth:`conservation_batch`."""
        return self._query_batch(record, windows, k, membership=True)

    # ----------------------------------------------------------------- internals
    def _window_params(self, record: str, starts, L: int, k: int) -> WindowParams:
        """The kernel parameters of windows [qs, qs + L) of ``record``, one
        per ``qs`` of ``starts``, on the device: the candidate rows [mlo,
        mhi) of the start-order stream and [plo, phi) of the end-order
        stream, the coverage entering position 0, and the candidate counts
        (:func:`~memo_tpu_torch.query.window.window_params`)."""
        return window_params(self._d, self._layout, self.store.record_index(record), starts, L, k)

    def _window_bounds(self, record: str, qs: int, qe: int, k: int) -> tuple[int, int]:
        """``IntervalStore.window_bounds`` over this engine's placed rows."""
        return window_bounds(self._d, self._layout, self.store.record_index(record), qs, qe, k)

    def _query(self, record: str, qs: int, qe: int, k: int, membership: bool):
        if qe < qs:
            raise ValueError(f"empty/negative region {record}:{qs}-{qe}")
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if self._children is not None:
            return self._query_stratified(record, qs, qe, k, membership)
        n = self.n_docs
        stats = QueryStats(positions=qe - qs)
        chunks = [(c_qs, min(c_qs + self.chunk_positions, qe))
                  for c_qs in range(qs, qe, self.chunk_positions)]
        if self.backend == "fused":
            outputs = self._query_chunk_fused(record, chunks, k, membership, stats)
        else:
            outputs = [self._query_chunk(record, c_qs, c_qe, k, membership, stats)
                       for c_qs, c_qe in chunks]
        stats.chunks += len(chunks)
        self.last_stats = stats
        if self.device_output:
            if not outputs:
                if membership:
                    return torch.zeros((0, n), dtype=torch.int8, device=self.device)
                return torch.zeros(0, dtype=torch.int32, device=self.device)
            return torch.cat(outputs) if len(outputs) > 1 else outputs[0]
        if membership:
            return np.concatenate(outputs, axis=0) if outputs else np.zeros((0, n), np.int8)
        return np.concatenate(outputs) if outputs else np.zeros(0, np.int64)

    def _query_batch(self, record: str, windows, k: int, membership: bool) -> list:
        windows = [(int(qs), int(qe)) for qs, qe in windows]
        for qs, qe in windows:
            if qe < qs:
                raise ValueError(f"empty/negative window {qs}-{qe}")
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if not windows:
            return []
        out = self._batch_tensor(record, windows, k, membership)
        if out is None:
            return self._query_batch_windows(record, windows, k, membership)
        if not self.device_output:
            out = out.cpu().numpy()
        return [out[i, : qe - qs] for i, (qs, qe) in enumerate(windows)]

    def _batch_tensor(self, record, windows, k, membership) -> torch.Tensor | None:
        """The batch of ``windows`` (checked, nonempty) as one device tensor
        [Q, L(, C)], L the longest window, from one launch of the kernel per
        length bucket that can mark (bucket outputs min-combined as in
        :meth:`_query_stratified`): row i's first ``qe - qs`` positions are
        window i's output (exact: a window's row is what the single-window
        kernel computes over [qs, qs + L)). None where the batch runs per
        window: another backend, windows longer than ``chunk_positions`` or
        all empty, or candidate sets over the bucket cap."""
        if self._children is None:
            plan = self._batch_plan(record, windows, k)
            return None if plan is None else self._run_batch(plan, windows, k, membership)
        live = [child for lb, child in self._children if lb < k - 1]
        plans = [child._batch_plan(record, windows, k) for child in live]
        if any(plan is None for plan in plans):
            return None
        stats = QueryStats(positions=sum(qe - qs for qs, qe in windows))
        acc = None
        for child, plan in zip(live, plans):
            out = child._run_batch(plan, windows, k, membership)
            stats.candidate_intervals += child.last_stats.candidate_intervals
            stats.chunks += child.last_stats.chunks
            acc = out if acc is None else torch.minimum(acc, out, out=acc)
        self.last_stats = stats
        if acc is None:  # k too small for any stored interval: nothing marks
            acc = self._unmarked((len(windows), max(qe - qs for qs, qe in windows)), membership)
        return acc

    def _batch_plan(self, record, windows, k):
        """(window parameters, L, candidate counts) of one launch over
        ``windows``, or None where the batch runs per window. Reads the
        counts back: 2 integers a window."""
        L = max(qe - qs for qs, qe in windows)
        # A batch of empty windows has nothing to launch.
        if self.backend != "fused" or not 0 < L <= self.chunk_positions:
            return None
        wp = self._window_params(record, [qs for qs, _ in windows], L, k)
        counts = [max(m, p) for m, p in zip(*wp.counts.tolist())]
        if max(counts) > self.max_intervals:
            return None
        return wp, L, counts

    def _run_batch(self, plan, windows, k, membership) -> torch.Tensor:
        # memo_tpu pads the window count to a power of two to bound the
        # programs XLA compiles; nothing here compiles per shape, so the
        # batch keeps its own count.
        wp, L, counts = plan
        out = self._run_kernel(wp, k, L, membership)
        self.last_stats = QueryStats(
            candidate_intervals=sum(counts),
            chunks=len(windows),
            positions=sum(qe - qs for qs, qe in windows),
        )
        return out

    def _query_batch_windows(self, record, windows, k, membership) -> list:
        """The batch where it does not run as one launch: per window, or
        per bucket (min-combined as in :meth:`_query_stratified`)."""
        stats = QueryStats()
        if self._children is None:
            outs = []
            for qs, qe in windows:
                outs.append(self._query(record, qs, qe, k, membership))
                stats.candidate_intervals += self.last_stats.candidate_intervals
                stats.chunks += self.last_stats.chunks
                stats.positions += self.last_stats.positions
            self.last_stats = stats
            return outs
        stats.positions = sum(qe - qs for qs, qe in windows)
        accs = None
        for lb, child in self._children:
            if lb >= k - 1:
                continue
            outs = child._query_batch(record, windows, k, membership)
            stats.candidate_intervals += child.last_stats.candidate_intervals
            stats.chunks += child.last_stats.chunks
            accs = outs if accs is None else [torch.minimum(a, o) for a, o in zip(accs, outs)]
        self.last_stats = stats
        if accs is None:  # k too small for any stored interval: nothing marks
            accs = [self._unmarked((qe - qs,), membership) for qs, qe in windows]
        return accs if self.device_output else [a.cpu().numpy() for a in accs]

    def _finish(self, out: torch.Tensor):
        return out if self.device_output else out.cpu().numpy()

    def _cat(self, left, right):
        if self.device_output:
            return torch.cat([left, right])
        return np.concatenate([left, right], axis=0)

    def _query_chunk(self, record, qs, qe, k, membership, stats: QueryStats):
        """One position chunk on the ``numpy`` or ``torch`` backend."""
        L = qe - qs
        n = self.n_docs

        if self.backend == "numpy":
            lo, hi = self.store.window_bounds(record, qs, qe, k)
            stats.candidate_intervals += hi - lo
            s = self.store.start[lo:hi]
            e = self.store.end[lo:hi]
            o = self.store.order[lo:hi]
            marks = Q.coverage_marks_np(s, e, o, qs, k, L, n)
            return Q.membership_np(marks) if membership else Q.conservation_np(marks, n)

        lo, hi = self._window_bounds(record, qs, qe, k)
        count = hi - lo
        M = min(_next_pow2(max(count, 1)), self.max_intervals)
        if count > M:
            # More candidates than the bucket cap: halve the position chunk
            # (exact), down to interval pieces at a single position.
            mid = (qs + qe) // 2
            if mid == qs:
                return self._query_interval_pieces(record, qs, qe, k, membership, lo, hi, stats)
            left = self._query_chunk(record, qs, mid, k, membership, stats)
            right = self._query_chunk(record, mid, qe, k, membership, stats)
            return self._cat(left, right)
        stats.candidate_intervals += count
        return self._run_device_range(record, qs, k, membership, lo, M, L)

    def _run_device_range(self, record, qs, k, membership, lo, M, L):
        rec_end = int(self._layout.rec_offsets[self.store.record_index(record) + 1])
        return self._finish(
            _device_query(self._d, lo, rec_end, qs, k, M, L, self.n_docs, membership)
        )

    def _query_interval_pieces(self, record, qs, qe, k, membership, lo, hi, stats: QueryStats):
        """More covering intervals at one position than the bucket cap:
        coverage is additive over interval subsets, so marks are a union and
        per-piece outputs combine with an elementwise minimum."""
        L = qe - qs
        M = self.max_intervals
        acc = None
        for piece_lo in range(lo, hi, M):
            stats.candidate_intervals += min(piece_lo + M, hi) - piece_lo
            stats.chunks += 1
            out = self._run_device_range(record, qs, k, membership, piece_lo, M, L)
            if acc is None:
                acc = out
            elif self.device_output:
                acc = torch.minimum(acc, out)
            else:
                acc = np.minimum(acc, out)
        return acc

    def _query_chunk_fused(self, record, chunks, k, membership, stats: QueryStats) -> list:
        """The fused backend's position chunks [(qs, qe), ...]: each one's
        exact in-window event ranges in the two sorted streams and its
        prefix counts, found on the device by one window step per chunk
        length (the full chunks, then a shorter last one); then every
        chunk's kernel. On CUDA the kernels are launched before the host
        reads the candidate counts, which are copied back behind the steps,
        so the read waits for the steps alone and the host stays ahead of
        the card; a chunk over the cap is then run again in halves (exact
        either way), down to interval pieces at a single position. On the
        CPU the counts are known at once and a chunk over the cap is not
        launched (the plain version sizes its gathers by the cap)."""
        by_len: dict[int, list[int]] = {}
        for i, (c_qs, c_qe) in enumerate(chunks):
            by_len.setdefault(c_qe - c_qs, []).append(i)
        steps = [(L, rows, self._window_params(record, [chunks[i][0] for i in rows], L, k))
                 for L, rows in by_len.items()]
        if not steps:
            return []
        counts = [wp.counts for _, _, wp in steps]
        counts, ready = _copy_back(torch.cat(counts, 1) if len(counts) > 1 else counts[0])
        order = [i for _, rows, _ in steps for i in rows]

        def per_chunk() -> dict[int, int]:
            return dict(zip(order, (max(m, p) for m, p in zip(*counts.tolist()))))

        known = per_chunk() if ready is None else None
        outs: list = [None] * len(chunks)
        for L, rows, wp in steps:
            for j, i in enumerate(rows):
                if known is None or known[i] <= self.max_intervals:
                    one = WindowParams(wp.params[j : j + 1], wp.prefix[j : j + 1],
                                       wp.counts[:, j : j + 1])
                    outs[i] = self._run_kernel(one, k, L, membership)[0]
        if known is None:
            ready.synchronize()
            known = per_chunk()
        for i in order:
            count = known[i]
            if count <= self.max_intervals:
                stats.candidate_intervals += count
                outs[i] = self._finish(outs[i])
                continue
            c_qs, c_qe = chunks[i]
            mid = (c_qs + c_qe) // 2
            if mid == c_qs:
                # The two event streams do not split by interval subset, so a
                # single position over the cap goes through the diff-array ops.
                lo, hi = self._window_bounds(record, c_qs, c_qe, k)
                outs[i] = self._query_interval_pieces(record, c_qs, c_qe, k, membership, lo, hi,
                                                      stats)
            else:
                left, right = self._query_chunk_fused(record, [(c_qs, mid), (mid, c_qe)], k,
                                                      membership, stats)
                outs[i] = self._cat(left, right)
        return outs

    def _run_kernel(self, wp: WindowParams, k: int, L: int, membership: bool) -> torch.Tensor:
        """The fused kernel on the Q windows of ``wp`` (their parameters on
        the device), L positions each. Output [Q, L] or [Q, L, C]."""
        n = self.n_docs
        run = fused_query_rows if self.kernel_version == "v1" else fused_query_v2_rows
        return run(self._d, wp.params, wp.prefix, k=k, L=L, C=n, n_docs=n, membership=membership)


def _copy_back(t: torch.Tensor) -> tuple[torch.Tensor, torch.cuda.Event | None]:
    """``t`` on the host: a CUDA tensor is copied into pinned memory behind
    the work queued so far, without waiting for it, and comes with the event
    to wait on before reading it; a CPU tensor is itself, ready."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record()
    return host, ready


def _device_query(d: PlacedStore, lo, rec_end, qs, k, M, L, n, membership):
    """Diff-array query of M store rows from ``lo`` (memo_tpu engine
    ``_device_query_fn``). Rows past the record's end belong to another
    record's coordinates and are dropped."""
    s = d.start[lo : lo + M]
    e = d.end[lo : lo + M]
    idx = lo + torch.arange(s.numel(), dtype=torch.int64, device=s.device)
    o = torch.where(idx < rec_end, d.order[lo : lo + M], -1)
    marks = Q.coverage_marks(s, e, o, qs, k, L=L, C=n)
    return Q.membership_from_marks(marks) if membership else Q.conservation_from_marks(marks, n)
