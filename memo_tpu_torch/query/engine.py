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
kernel. The fused kernels read only a window's candidate ranges, so they
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
from memo_tpu_torch.ops.fused_query import fused_query_rows
from memo_tpu_torch.ops.fused_query_v2 import ROW_SLACK, fused_query_v2_rows
from memo_tpu_torch.query.window import WindowParams, window_bounds, window_params
from memo_tpu_torch.utils.device import resolve_device
from memo_tpu_torch.utils.profiling import stage_timer

BACKENDS = ("fused", "torch", "numpy")
KERNEL_VERSIONS = ("v1", "v2")  # fused kernel generations, as memo_tpu names them


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


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
        # No reader slices past the placed rows but v2, whose 16-byte copies
        # read up to ROW_SLACK rows past a range and which wants more than
        # ROW_SLACK rows.
        self._d, self._layout = place_columns(cols, self.store.num_records, self.n_docs,
                                              ROW_SLACK + 1)

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
        buckets whose minimum length >= k-1 hold no live interval. On the
        fused backend every live bucket's steps and kernels are queued and
        nothing is read (:func:`_fused_chunks`)."""
        L = qe - qs
        stats = QueryStats(positions=L)
        live = [child for lb, child in self._children if lb < k - 1]
        if self.backend == "fused" and live:
            chunks = self._chunks(qs, qe)
            each = [QueryStats(chunks=len(chunks), positions=L) for _ in live]
            outs = [child._join(out, membership) for child, out in
                    zip(live, _fused_chunks(live, record, chunks, k, membership, each))]
            for child, child_stats in zip(live, each):
                child.last_stats = child_stats
        else:
            outs = [child._query(record, qs, qe, k, membership) for child in live]
            each = [child.last_stats for child in live]
        acc = None
        for out, child_stats in zip(outs, each):
            stats.add(child_stats)
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
        ``fused`` backend the batch is one call of the kernel wrapper: every
        window runs at the batch's longest length L from its own candidate
        ranges and prefix, and keeps its first ``qe - qs`` positions (exact:
        a window's row is what the single-window kernel computes over
        [qs, qs + L)). Windows longer than ``chunk_positions`` and the other
        backends run per window."""
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
        chunks = self._chunks(qs, qe)
        stats = QueryStats(chunks=len(chunks), positions=qe - qs)
        if self.backend == "fused":
            outputs = self._query_chunk_fused(record, chunks, k, membership, stats)
        else:
            outputs = [self._query_chunk(record, c_qs, c_qe, k, membership, stats)
                       for c_qs, c_qe in chunks]
        self.last_stats = stats
        return self._join(outputs, membership)

    def _chunks(self, qs: int, qe: int) -> list[tuple[int, int]]:
        """The position chunks of [qs, qe): full ones of ``chunk_positions``,
        then a shorter last one."""
        return [(c_qs, min(c_qs + self.chunk_positions, qe))
                for c_qs in range(qs, qe, self.chunk_positions)]

    def _join(self, outputs: list, membership: bool):
        """A query's chunk outputs as one output, in order."""
        n = self.n_docs
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
        :meth:`_query_stratified`), whatever the candidate counts: row i's
        first ``qe - qs`` positions are window i's output (exact: a window's
        row is what the single-window kernel computes over [qs, qs + L)).
        Every bucket's window step is queued, then its kernel; nothing is
        read. None where the batch runs per window: another backend, or
        windows longer than ``chunk_positions`` or all empty."""
        L = max(qe - qs for qs, qe in windows)
        positions = sum(qe - qs for qs, qe in windows)
        engines = ([self] if self._children is None
                   else [child for lb, child in self._children if lb < k - 1])
        if not engines:  # k too small for any stored interval: nothing marks
            self.last_stats = QueryStats(positions=positions)
            return self._unmarked((len(windows), L), membership)
        # A batch of empty windows has nothing to launch.
        if self.backend != "fused" or not 0 < L <= self.chunk_positions:
            return None
        # memo_tpu pads the window count to a power of two to bound the
        # programs XLA compiles; nothing here compiles per shape, so the
        # batch keeps its own count.
        chunks = [(qs, qs + L) for qs, _ in windows]
        steps = [eng._chunk_steps(record, chunks, k) for eng in engines]
        stats, acc = QueryStats(positions=positions), None
        for eng, eng_steps in zip(engines, steps):
            out = eng._run_kernel(eng_steps[0][2], k, L, membership)
            part = QueryStats(positions=positions)
            part.add_later(_Replay.of(eng, record, k, chunks, eng_steps, windows))
            eng.last_stats = part
            stats.add(part)
            acc = out if acc is None else torch.minimum(acc, out, out=acc)
        self.last_stats = stats
        return acc

    def _query_batch_windows(self, record, windows, k, membership) -> list:
        """The batch where it does not run as one launch: per window, or
        per bucket (min-combined as in :meth:`_query_stratified`)."""
        stats = QueryStats()
        if self._children is None:
            outs = []
            for qs, qe in windows:
                outs.append(self._query(record, qs, qe, k, membership))
                stats.add(self.last_stats)
                stats.positions += self.last_stats.positions
            self.last_stats = stats
            return outs
        stats.positions = sum(qe - qs for qs, qe in windows)
        accs = None
        for lb, child in self._children:
            if lb >= k - 1:
                continue
            outs = child._query_batch(record, windows, k, membership)
            stats.add(child.last_stats)
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

    def _chunk_steps(self, record: str, chunks, k: int) -> list:
        """The window steps of the position chunks [(qs, qe), ...] of
        ``record`` (:func:`_window_steps`)."""
        return _window_steps(self._d, self._layout, self.store.record_index(record), chunks, k)

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

    def _query_chunk_fused(self, record, chunks, k, membership, stats: QueryStats) -> list:
        """The fused backend's position chunks [(qs, qe), ...] of this
        engine (:func:`_fused_chunks`): their outputs, in order."""
        outs = _fused_chunks([self], record, chunks, k, membership, [stats])[0]
        return [self._finish(out) for out in outs]

    def _run_kernel(self, wp: WindowParams, k: int, L: int, membership: bool) -> torch.Tensor:
        """The fused kernel on the Q windows of ``wp`` (their parameters on
        the device), L positions each. Output [Q, L] or [Q, L, C]."""
        n = self.n_docs
        run = fused_query_rows if self.kernel_version == "v1" else fused_query_v2_rows
        return run(self._d, wp.params, wp.prefix, k=k, L=L, C=n, n_docs=n, membership=membership)


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


def _window_steps(placed: PlacedStore, layout: DeviceLayout, r: int, chunks, k: int) -> list:
    """The window steps of the position chunks [(qs, qe), ...] of record
    ``r``, found on the device: (L, chunk indices, WindowParams), one step
    per chunk length (the full chunks, then a shorter last one); nothing is
    read back."""
    by_len: dict[int, list[int]] = {}
    for i, (c_qs, c_qe) in enumerate(chunks):
        by_len.setdefault(c_qe - c_qs, []).append(i)
    return [(L, rows, window_params(placed, layout, r, [chunks[i][0] for i in rows], L, k))
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


def _fused_chunks(engines: list, record: str, chunks, k: int, membership: bool,
                  stats: list) -> list[list]:
    """The position chunks [(qs, qe), ...] of a query through each of
    ``engines`` (one, or the live length buckets), each one's device outputs
    in chunk order. Every engine's window steps are queued, then every
    chunk's kernel, whatever its candidate count; nothing is read back, and
    the host waits on nothing. Each engine's entry of ``stats`` keeps its
    steps, for memo_tpu's halving to be replayed when first read
    (:class:`_Replay`)."""
    if not chunks:
        return [[] for _ in engines]
    steps = [engine._chunk_steps(record, chunks, k) for engine in engines]
    for engine, engine_steps, engine_stats in zip(engines, steps, stats):
        engine_stats.add_later(_Replay.of(engine, record, k, chunks, engine_steps))
    return [engine._launch_chunks(chunks, engine_steps, k, membership)
            for engine, engine_steps in zip(engines, steps)]


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
    """Diff-array query of up to M store rows from ``lo`` (memo_tpu engine
    ``_device_query_fn``), the slice ending at the placed rows' end, where
    memo_tpu's ``dynamic_slice`` needs M sentinel rows there: rows past the
    window's candidates never mark. Rows past the record's end belong to
    another record's coordinates and are dropped."""
    hi = min(lo + M, d.start.numel())
    s, e = d.start[lo:hi], d.end[lo:hi]
    idx = torch.arange(lo, hi, dtype=torch.int64, device=s.device)
    o = torch.where(idx < rec_end, d.order[lo:hi], -1)
    marks = Q.coverage_marks(s, e, o, qs, k, L=L, C=n)
    return Q.membership_from_marks(marks) if membership else Q.conservation_from_marks(marks, n)
