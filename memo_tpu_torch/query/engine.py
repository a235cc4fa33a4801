"""Query orchestration on PyTorch: interval store -> device tensors ->
conservation/membership.

Counterpart of :mod:`memo_tpu.query.engine`, with the same contracts. The
store's columns go to the device once, and its length buckets and query
layout are built and kept there (:mod:`memo_tpu_torch.index.placement`);
then

1. the candidate row ranges and the prefix of the windows, searched on the
   device (:mod:`memo_tpu_torch.query.window`); a fused query reads none of
   them back,
2. a device step per (window, interval bucket): the fused CUDA kernel
   (backend ``fused``; v1 and v2 both read the placed rows of the candidate
   ranges), or the diff-array tensor ops (backend ``torch``); ``numpy``
   runs on the host,
3. bit-exact text output (:mod:`memo_tpu_torch.query.output`).

Large windows run in position chunks; dense stores split into length
buckets (the proofs are in the JAX engine's docstrings and in
memo_tpu/ops/query_ops.py). A batch of windows of one record
(``conservation_batch``/``membership_batch``) runs as one launch of the
kernel, each window over its own length, into one packed output. The
fused kernels read only a window's candidate ranges, so they
take a chunk whole whatever its candidate count; memo_tpu's halving of a
chunk over the cap lives on only in ``last_stats``, replayed from the
window steps when first read. The kernel wrappers take any window count
and any width (``fused_query.launch_groups`` launches a larger batch or a
wider store as groups). The ``torch`` backend halves as memo_tpu's
XLA path does, down to interval pieces combined with an elementwise
minimum; PyTorch runs eagerly, so there the pow2 candidate bucket M only
bounds the working set of one step.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import itertools
import os
from typing import NamedTuple

import numpy as np
import torch

from memo_tpu_torch.index.placement import (
    Columns,
    DeviceLayout,
    PlacedStore,
    place_columns,
    place_store_and_layout,
    short_share,
    split_by_length,
    upload_columns,
)
from memo_tpu_torch.index.store import IntervalStore
from memo_tpu_torch.ops import query_ops as Q
from memo_tpu_torch.ops.fused_query import Offsets, fused_query_rows
from memo_tpu_torch.ops.fused_query_v2 import ROW_SLACK, fused_query_v2_rows
from memo_tpu_torch.query.window import WindowParams, ragged_table, window_bounds, window_params
from memo_tpu_torch.utils.device import resolve_device
from memo_tpu_torch.utils.profiling import count, span, stage_timer

BACKENDS = ("fused", "torch", "numpy")
KERNEL_VERSIONS = ("v1", "v2")  # fused kernel generations, as memo_tpu names them
# A batch launches ragged (each window over its own length) only where its
# padded positions, Q x the longest length, exceed its answered ones by more
# than this: the ragged launch's lookup costs v1 8-17% a tile on an H100
# (PERF.md, ops.fused_query), so a nearly uniform batch keeps the uniform launch.
RAGGED_PADDING = 1.2


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _ragged(lengths: list[int]) -> bool:
    """Whether a batch of windows of ``lengths`` (nonempty) launches ragged:
    whether its padding, Q x the longest length, exceeds its answered
    positions by more than :data:`RAGGED_PADDING`."""
    return len(lengths) * max(lengths) > RAGGED_PADDING * sum(lengths)


class _Batch(NamedTuple):
    """A batch on the device (:meth:`QueryEngine._batch_tensor`)."""
    out: torch.Tensor  # one flat tensor
    offsets: list[int]  # each window's offset into ``out``
    one_launch: bool  # one launch answered it, not a query a window


class _Replayed:
    """A field of :class:`QueryStats` that fused queries may leave to be
    found: the value so far, plus what the pending replays
    (:meth:`QueryStats.add_later`) add, found on first access of either
    field."""

    def __set_name__(self, owner, name):
        self.key = "_" + name

    def __get__(self, stats, owner=None) -> int:
        if stats is None:
            return 0  # the field's default
        _settle(stats)
        return stats.__dict__[self.key]

    def __set__(self, stats, value: int) -> None:
        _settle(stats)
        stats.__dict__[self.key] = value


@dataclasses.dataclass
class QueryStats:
    """Per-query counters, as memo_tpu's engine keeps them. ``positions``
    is known at once. A fused query launches each chunk whole and leaves
    its candidate counts on the device (:meth:`add_later`);
    ``candidate_intervals`` and ``chunks`` replay memo_tpu's halving from
    them on first access, as does any use of the fields (``==``,
    ``as_dict``, ``dataclasses.asdict``)."""

    candidate_intervals: int = _Replayed()
    chunks: int = _Replayed()
    positions: int = 0

    def add_later(self, replay: _Replay) -> None:
        """Adds what ``replay`` finds, when first asked for."""
        self.__dict__["_later"] = [*self.__dict__.get("_later", ()), replay]

    def add(self, other: QueryStats) -> None:
        """Adds another query's candidates and chunks, reading nothing."""
        for key in ("_candidate_intervals", "_chunks"):
            self.__dict__[key] += other.__dict__[key]
        later = other.__dict__.get("_later")
        if later:
            self.__dict__["_later"] = [*self.__dict__.get("_later", ()), *later]

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _settle(stats: QueryStats) -> None:
    """Adds the pending replays' candidates and chunks into ``stats``."""
    for replay in stats.__dict__.pop("_later", ()):
        candidates, chunks = replay.run()
        stats.__dict__["_candidate_intervals"] += candidates
        stats.__dict__["_chunks"] += chunks


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
    the device instead of numpy arrays. Host answers come back through
    :func:`_to_host`, in one copy and one wait a call (a batch's answers are
    views of one copy); on CUDA they live in pinned memory from PyTorch's
    caching host allocator, which stays pinned while the caller holds an
    answer and cached by the allocator once the caller drops it: the
    page-locked bytes are at their peak the held answers' bytes, each
    rounded up to a power of two, and stay pinned for the life of the
    process. ``kernel_version``
    picks the fused kernel: "v1" (``csrc/fused_query.cu``) or "v2"
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
        # No reader slices past the placed rows but v2, whose 16-byte copies
        # read up to ROW_SLACK rows past a range and which wants more than
        # ROW_SLACK rows.
        self._d, self._layout = place_columns(cols, self.store.num_records, self.n_docs,
                                              ROW_SLACK + 1)

    def _init_stratified(self, buckets: list[tuple[int, Columns]]) -> None:
        """One child engine per nonempty length bucket, placed from the
        bucket's rows on the device (its layout holds their record offsets
        and longest intervals; ``store`` is the parent's, shared); each child
        has the parent's settings, as in memo_tpu. The parent joins the
        children's device outputs (:meth:`_join`)."""
        children: list[tuple[int, QueryEngine]] = []
        while buckets:  # popped, so each bucket's device columns go once it is placed
            b, sub_cols = buckets.pop(0)
            child = copy.copy(self)
            child.last_stats = QueryStats()
            child._place(sub_cols)
            children.append((0 if b == 0 else self.STRATA_EDGES[b - 1], child))
        self._children = children

    def _engines(self, k: int | None = None) -> list[QueryEngine]:
        """The engines a query at ``k`` runs on: this one, or the length
        buckets that can mark at k (an interval marks only where its length
        is below k - 1); without ``k``, every engine that holds rows."""
        if self._children is None:
            return [self]
        return [child for lb, child in self._children if k is None or lb < k - 1]

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
        ``fused`` backend the batch is one call of the kernel wrapper: every
        window's candidate ranges and prefix are found at the batch's longest
        length L, the kernels launch over its own ``qe - qs`` positions only
        (exact: those are the first positions of what the single-window
        kernel computes over [qs, qs + L)), and the answers are views of one
        packed output. Windows longer than ``chunk_positions`` and the
        ``torch`` backend run per window, their answers packed into one
        output; ``numpy`` answers per window on the host."""
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

    def _query(self, record: str, qs: int, qe: int, k: int, membership: bool,
               deliver: bool = True):
        """The answer of [qs, qe): its position chunks through each engine
        that can mark at k, joined on the device (:meth:`_join`) and handed
        to the caller (:meth:`_deliver`), or, without ``deliver``, left on
        the device. The ``numpy`` backend answers on the host."""
        if qe < qs:
            raise ValueError(f"empty/negative region {record}:{qs}-{qe}")
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        with span("memo.query"):
            chunks = self._chunks(qs, qe)
            if self.backend == "numpy":
                return self._query_numpy(record, chunks, k, membership)
            engines = self._engines(k)
            each = [QueryStats(chunks=len(chunks), positions=qe - qs) for _ in engines]
            if self.backend == "torch" or not chunks:
                outs = [[eng._query_chunk(record, c_qs, c_qe, k, membership, part)
                         for c_qs, c_qe in chunks] for eng, part in zip(engines, each)]
            else:
                # Every engine's window steps, then every chunk's kernel,
                # whatever its candidate count; nothing is read back. Each
                # engine's stats keep its steps, for memo_tpu's halving to be
                # replayed when first read (:class:`_Replay`).
                r = self.store.record_index(record)
                steps = [_window_steps(eng._d, eng._layout, r, chunks, k) for eng in engines]
                for eng, eng_steps, part in zip(engines, steps, each):
                    part.add_later(_Replay.of(eng, record, k, chunks, eng_steps))
                outs = [eng._launch_chunks(chunks, eng_steps, k, membership)
                        for eng, eng_steps in zip(engines, steps)]
            out = self._join(engines, outs, each, qe - qs, qe - qs, membership)
            return self._deliver(out, membership) if deliver else out

    def _chunks(self, qs: int, qe: int) -> list[tuple[int, int]]:
        """The position chunks of [qs, qe): full ones of ``chunk_positions``,
        then a shorter last one."""
        return [(c_qs, min(c_qs + self.chunk_positions, qe))
                for c_qs in range(qs, qe, self.chunk_positions)]

    def _join(self, engines: list, outs: list, each: list, n: int, positions: int,
              membership: bool) -> torch.Tensor:
        """One answer [n(, C)] on the device from the outputs ``outs`` of
        ``engines`` (each engine's in order: its chunks, or a batch's one
        launch): an engine's outputs joined by ``torch.cat`` where it has
        several, the engines' answers min-combined (the union of their
        marks) where several are live, the unmarked value where none is (k
        too small for any stored interval) or none has an output (an empty
        window). Each engine's ``last_stats`` is its entry of ``each``, and
        this engine's is their sum over ``positions``."""
        stats, acc = QueryStats(positions=positions), None
        with span("memo.join"):
            for eng, pieces, part in zip(engines, outs, each):
                eng.last_stats = part
                stats.add(part)
                if pieces:
                    out = torch.cat(pieces) if len(pieces) > 1 else pieces[0]
                    acc = out if acc is None else torch.minimum(acc, out, out=acc)
            if acc is None:
                acc = self._unmarked((n,), membership)
        self.last_stats = stats
        return acc

    def _deliver(self, out: torch.Tensor, membership: bool, views=None, one_launch=False):
        """A device answer to the caller: itself (``device_output``) or
        brought to the host in one copy and one wait (:func:`_to_host`);
        with ``views`` [(offset, length), ...], a batch's views of it. On
        the host a plain engine's empty window, unless a batch's
        ``one_launch`` answered it, is memo_tpu's :meth:`_no_chunks`."""
        if not self.device_output:
            out = _to_host(out)
        joined = not (self.device_output or self._children or one_launch)
        if views is None:
            return self._no_chunks(membership) if joined and not len(out) else out
        with span("memo.views"):
            return [self._no_chunks(membership) if joined and not m else out[at : at + m]
                    for at, m in views]

    def _no_chunks(self, membership: bool) -> np.ndarray:
        """memo_tpu's host join of no position chunks (conservation int64)."""
        return np.zeros((0, self.n_docs), np.int8) if membership else np.zeros(0, np.int64)

    def _query_batch(self, record: str, windows, k: int, membership: bool) -> list:
        with span("memo.batch"):
            windows = [(int(qs), int(qe)) for qs, qe in windows]
            for qs, qe in windows:
                if qe < qs:
                    raise ValueError(f"empty/negative window {qs}-{qe}")
            if k < 1:
                raise ValueError(f"k must be >= 1, got {k}")
            if not windows:
                return []
            if self.backend == "numpy":
                return self._per_window(record, windows, k, membership)
            batch = self._batch_tensor(record, windows, k, membership)
            views = zip(batch.offsets, (qe - qs for qs, qe in windows))
            return self._deliver(batch.out, membership, views, batch.one_launch)

    def _per_window(self, record: str, windows, k: int, membership: bool) -> list:
        """Each window's query, left on the device; ``last_stats`` their sum."""
        outs, stats = [], QueryStats(positions=sum(qe - qs for qs, qe in windows))
        for qs, qe in windows:
            outs.append(self._query(record, qs, qe, k, membership, deliver=False))
            stats.add(self.last_stats)
        self.last_stats = stats
        return outs

    def _batch_tensor(self, record, windows, k, membership) -> _Batch:
        """The batch of ``windows`` (checked, nonempty) as one flat device
        tensor [N(, C)] and each window's offset into it. On the fused
        backend, windows within ``chunk_positions`` and not all empty, it is
        one launch per length bucket that can mark, whatever the candidate
        counts; every window's step runs at the longest length L, as
        memo_tpu's (so are the candidate counts and ``last_stats``), and
        every step is queued before the kernels; nothing is read. Ragged
        (:func:`_ragged`), each window is launched over its own length and
        packed, N the sum of the lengths (the starts and offsets go up in
        one copy, :func:`~memo_tpu_torch.query.window.ragged_table`); else
        over [Q, L], N = Q x L, window i from i x L. Exact either way: a
        window's positions are the first of what the single-window kernel
        computes over [qs, qs + L). Any other batch runs per window, its
        answers packed."""
        lengths = [qe - qs for qs, qe in windows]
        L, positions = max(lengths), sum(lengths)
        packed = list(itertools.accumulate(lengths[:-1], initial=0))
        if self.backend != "fused" or not 0 < L <= self.chunk_positions:
            outs = self._per_window(record, windows, k, membership)
            return _Batch(torch.cat(outs) if len(outs) > 1 else outs[0], packed, False)
        # memo_tpu pads the window count to a power of two to bound the
        # programs XLA compiles; nothing here compiles per shape, so the
        # batch keeps its own count.
        engines = self._engines(k)
        ragged = _ragged(lengths)
        chunks = [(qs, qs + L) for qs, _ in windows]
        starts, offsets = None, None
        if ragged and engines:
            starts, offsets = ragged_table([qs for qs, _ in windows], lengths,
                                           engines[0]._d.start.device)
        r = self.store.record_index(record)
        steps = [_window_steps(eng._d, eng._layout, r, chunks, k, starts) for eng in engines]
        outs, each = [], []
        for eng, eng_steps in zip(engines, steps):
            out = eng._run_kernel(eng_steps[0][2], k, L, membership, offsets)
            outs.append([out if ragged else out.flatten(0, 1)])
            each.append(QueryStats(positions=positions))
            each[-1].add_later(_Replay.of(eng, record, k, chunks, eng_steps, windows))
        out = self._join(engines, outs, each, positions if ragged else len(windows) * L,
                         positions, membership)
        return _Batch(out, packed if ragged else [i * L for i in range(len(windows))], True)

    def _query_numpy(self, record: str, chunks, k: int, membership: bool) -> np.ndarray:
        """The ``numpy`` backend's window of position chunks ``chunks``:
        each searched and answered on the host, joined there."""
        st, n = self.store, self.n_docs
        stats = QueryStats(chunks=len(chunks), positions=sum(qe - qs for qs, qe in chunks))
        outputs = []
        for qs, qe in chunks:
            lo, hi = st.window_bounds(record, qs, qe, k)
            stats.candidate_intervals += hi - lo
            marks = Q.coverage_marks_np(st.start[lo:hi], st.end[lo:hi], st.order[lo:hi], qs, k,
                                        qe - qs, n)
            outputs.append(Q.membership_np(marks) if membership else Q.conservation_np(marks, n))
        self.last_stats = stats
        with span("memo.join"):
            return np.concatenate(outputs) if outputs else self._no_chunks(membership)

    def _query_chunk(self, record, qs, qe, k, membership, stats: QueryStats) -> torch.Tensor:
        """One position chunk on the ``torch`` backend, on the device."""
        lo, hi = self._window_bounds(record, qs, qe, k)
        rows = hi - lo
        M = min(_next_pow2(max(rows, 1)), self.max_intervals)
        if rows > M:
            # More candidates than the bucket cap: halve the position chunk
            # (exact), down to interval pieces at a single position.
            mid = (qs + qe) // 2
            if mid == qs:
                return self._query_interval_pieces(record, qs, qe, k, membership, lo, hi, stats)
            return torch.cat([self._query_chunk(record, qs, mid, k, membership, stats),
                              self._query_chunk(record, mid, qe, k, membership, stats)])
        stats.candidate_intervals += rows
        return self._run_device_range(record, qs, k, membership, lo, M, qe - qs)

    def _run_device_range(self, record, qs, k, membership, lo, M, L) -> torch.Tensor:
        """Diff-array query of up to M placed rows from ``lo`` (memo_tpu
        engine ``_device_query_fn``), the slice ending at the placed rows'
        end, where memo_tpu's ``dynamic_slice`` needs M sentinel rows there:
        rows past the window's candidates never mark. Rows past the record's
        end belong to another record's coordinates and are dropped."""
        d, n = self._d, self.n_docs
        rec_end = int(self._layout.rec_offsets[self.store.record_index(record) + 1])
        hi = min(lo + M, d.start.numel())
        idx = torch.arange(lo, hi, dtype=torch.int64, device=d.start.device)
        o = torch.where(idx < rec_end, d.order[lo:hi], -1)
        marks = Q.coverage_marks(d.start[lo:hi], d.end[lo:hi], o, qs, k, L=L, C=n)
        return Q.membership_from_marks(marks) if membership else Q.conservation_from_marks(marks, n)

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
            acc = out if acc is None else torch.minimum(acc, out)
        return acc

    def _launch_chunks(self, chunks, steps: list, k: int, membership: bool) -> list:
        """Each chunk's kernel, one launch a chunk, whatever its candidate
        count (the kernels read only its candidate ranges): the [L(, C)]
        device outputs, in chunk order."""
        outs: list = [None] * len(chunks)
        for L, rows, wp in steps:
            for j, i in enumerate(rows):
                one = wp if len(rows) == 1 else WindowParams(
                    wp.params[j : j + 1], wp.prefix[j : j + 1], wp.counts[:, j : j + 1])
                outs[i] = self._run_kernel(one, k, L, membership)[0]
        return outs

    def _run_kernel(self, wp: WindowParams, k: int, L: int, membership: bool,
                    offsets: Offsets | None = None) -> torch.Tensor:
        """The fused kernel on the Q windows of ``wp`` (their parameters on
        the device), L positions each: output [Q, L] or [Q, L, C]; or, with
        a ragged batch's ``offsets``, each its own length, packed."""
        n = self.n_docs
        run = fused_query_rows if self.kernel_version == "v1" else fused_query_v2_rows
        with span("memo.launch"):
            out = run(self._d, wp.params, wp.prefix, k=k, L=L, C=n, n_docs=n,
                      membership=membership, offsets=offsets)
        count("memo.positions_launched",
              wp.params.shape[0] * L if offsets is None else offsets.total)
        count("memo.candidate_rows", wp.counts)
        return out


class _Replay(NamedTuple):
    """What a fused query leaves for ``last_stats`` in one engine (or
    length bucket): the window steps of the chunks it launched whole, on
    the device, and what memo_tpu's halving of them needs: the engine's
    placed rows and layout (not the engine, which holds the stats), the
    record's index, k and the cap. ``windows`` are a batch's own windows,
    whose ``chunks`` run at the batch's longest length; ``stream`` is the
    one that wrote the counts."""

    placed: PlacedStore
    layout: DeviceLayout
    r: int
    k: int
    cap: int
    chunks: list
    steps: list
    windows: list | None
    stream: tuple | None

    @classmethod
    def of(cls, engine: QueryEngine, record: str, k: int, chunks, steps: list,
           windows=None) -> _Replay:
        device = engine._d.start.device
        stream = torch._C._cuda_getCurrentStream(device.index) if device.type == "cuda" else None
        return cls(engine._d, engine._layout, engine.store.record_index(record), k,
                   engine.max_intervals, chunks, steps, windows, stream)

    def run(self) -> tuple[int, int]:
        """(candidates, chunks) to add, as memo_tpu's engine counts them,
        read and searched on the stream that wrote the counts: a query's
        candidates (its chunks are counted at once); a batch within the cap
        is one program of its windows, one over it runs window by window,
        each nonempty window a query of one chunk."""
        on = contextlib.nullcontext() if self.stream is None else torch.cuda.stream(
            torch.cuda.Stream(stream_id=self.stream[0], device_index=self.stream[1],
                              device_type=self.stream[2]))
        with on:
            if self.windows is None:
                return self._halving(self.chunks, self.steps), 0
            counts = _larger_counts(self.chunks, self.steps)
            if max(counts) <= self.cap:
                return sum(counts), len(self.windows)
            chunks = [(qs, qe) for qs, qe in self.windows if qe > qs]
            steps = _window_steps(self.placed, self.layout, self.r, chunks, self.k)
            return self._halving(chunks, steps), len(chunks)

    def _halving(self, chunks, steps: list) -> int:
        """memo_tpu's candidate count of the position chunks ``chunks``
        (their window steps ``steps``) as its fused engine halves them at the
        cap (memo_tpu/query/engine.py:531-568): a chunk within the cap adds
        the larger of its two candidate counts; one over it counts as its
        halves at ``(qs + qe) // 2``, whose steps are found here, a level at
        a time. Both candidate ranges of a single position are empty, so the
        halving ends above it, and memo_tpu's interval pieces (its
        ``mid == qs`` branch) never run there."""
        candidates = 0
        while chunks:
            halves = []
            for (qs, qe), count in zip(chunks, _larger_counts(chunks, steps)):
                if count <= self.cap:
                    candidates += count
                else:
                    mid = (qs + qe) // 2
                    halves += [(qs, mid), (mid, qe)]
            chunks, steps = halves, _window_steps(self.placed, self.layout, self.r, halves, self.k)
        return candidates


def _window_steps(placed: PlacedStore, layout: DeviceLayout, r: int, chunks, k: int,
                  starts=None) -> list:
    """The window steps of the position chunks [(qs, qe), ...] of record
    ``r``, found on the device: (L, chunk indices, WindowParams), one step
    per chunk length (the full chunks, then a shorter last one); nothing is
    read back. ``starts``: the chunks' starts already on the device, where
    they all have one length (a ragged batch's, :func:`ragged_table`)."""
    with span("memo.window_step"):
        by_len: dict[int, list[int]] = {}
        for i, (c_qs, c_qe) in enumerate(chunks):
            by_len.setdefault(c_qe - c_qs, []).append(i)
        return [(L, rows, window_params(placed, layout, r,
                                        [chunks[i][0] for i in rows] if starts is None else starts,
                                        L, k))
                for L, rows in by_len.items()]


def _larger_counts(chunks, steps: list) -> list[int]:
    """The larger of each chunk's two candidate counts, in chunk order,
    from its window step's counts (one read)."""
    counts = [wp.counts for _, _, wp in steps]
    both = counts[0] if len(counts) == 1 else torch.cat(counts, 1)
    out = [0] * len(chunks)
    for i, m, p in zip((i for _, rows, _ in steps for i in rows), *both.tolist()):
        out[i] = max(m, p)
    return out


def _to_host(t: torch.Tensor) -> np.ndarray:
    """An answer brought to the host, as a numpy array, in one copy and one
    wait: a CUDA tensor is copied into pinned memory behind the work queued
    before it (:func:`_copy_back`) and the host waits for the copy; a CPU
    tensor is itself. The pinned block comes from PyTorch's caching host
    allocator and the caller owns it: it stays pinned while the caller holds
    the array (or a view of it), and once the caller drops it the allocator
    keeps it cached, still pinned, for a later answer. A block is the
    answer's bytes rounded up to a power of two; at its peak the process
    pins the sum of the blocks of the answers it holds, and a query raises
    where the host cannot pin a block. The wait and the copy are the span
    ``memo.copy_back``; the answer's bytes count in ``memo.copy_back_bytes``."""
    with span("memo.copy_back"):
        host, ready = _copy_back(t)
        if ready is not None:
            ready.synchronize()
    count("memo.copy_back_bytes", t.numel() * t.element_size())
    return host.numpy()


def _copy_back(t: torch.Tensor) -> tuple[torch.Tensor, torch.cuda.Event | None]:
    """``t`` on the host: a CUDA tensor is copied into pinned memory behind
    the work queued so far, without waiting for it, and comes with the event
    to wait on before reading it, recorded on the stream the copy runs on
    (``t``'s device's current stream, whichever device is current); a CPU
    tensor is itself, ready."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(t.device))
    return host, ready

