"""Batched window queries with host-gathered candidates, on one GPU.

Counterpart of :mod:`memo_tpu.parallel.sharded`. memo_tpu runs a batch of
windows SPMD over a (dp, sp) device mesh: ``dp`` shards the windows, and
``sp`` shards either each window's positions (``position``) or its candidate
intervals (``interval``, whose partial coverage counts a ``psum_scatter``
sums over ``sp``). The port runs on one device, the 1 x 1 layout, until its
multi-GPU slice (ROADMAP.md). On that layout the two strategies are the same
computation, the diff-array coverage of each window from its whole
candidate set (``query_ops.coverage_counts`` with a window dimension), and
the ``psum_scatter`` is the identity. The host side follows memo_tpu's: the
gather of candidate rows per window, pow2 buckets by candidate count, and
the padding of a bucket's windows to a multiple of dp with a repeat row.
"""

from __future__ import annotations

import numpy as np
import torch

from memo_tpu_torch.ops import query_ops as Q
from memo_tpu_torch.query.engine import _next_pow2
from memo_tpu_torch.utils.device import resolve_device

STRATEGIES = ("position", "interval")
MULTI_DEVICE_ITEM = (
    "ROADMAP.md queue 1: parallel/sharded.py and parallel/distributed.py on torch.distributed"
)


def check_layout(mesh) -> tuple[int, int]:
    """(dp, sp) of a device layout; only the one-device layout (1, 1) is
    ported, any other raises and names the ROADMAP item that ports it."""
    dp, sp = (int(x) for x in mesh)
    if (dp, sp) != (1, 1):
        raise ValueError(
            f"device layout {dp}x{sp} is not yet ported: memo_tpu_torch runs on one device (1x1) "
            f"until {MULTI_DEVICE_ITEM}"
        )
    return dp, sp


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


class ShardedQuery:
    """Batched queries over an :class:`IntervalStore` on ``device``.

    Gathers per-window candidate rows host-side (store.window_bounds), pads
    them to a shared pow2 bucket, and computes each bucket's windows in one
    batch of tensor ops. Results are bit-identical to the single-window
    engine.
    """

    def __init__(self, store, device="cuda", strategy: str = "position"):
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r}")
        self.store = store
        self.device = resolve_device(device)
        self.strategy = strategy
        self.dp, self.sp = 1, 1  # the one-device layout (see the module docstring)
        self.n_docs = store.n_docs

    def _window_rows(self, windows: list[tuple[str, int, int]], k: int):
        """Candidate row range (lo, hi) per (record, qs, qe) window."""
        st = self.store
        rows = []
        for record, qs, qe in windows:
            lo, hi = st.window_bounds(record, qs, qe, k)
            rec_end = int(st.rec_offsets[st.record_index(record) + 1])
            rows.append((lo, min(hi, rec_end)))  # rows past the record are another record's space
        return rows

    def _gather(self, rows: list[tuple[int, int]], M: int):
        """Padded [W, M] candidate tensors on the device for row ranges."""
        st = self.store
        W = len(rows)
        starts = np.zeros((W, M), np.int32)
        ends = np.zeros((W, M), np.int32)
        orders = np.full((W, M), -1, np.int32)  # order<0 rows are dropped
        for i, (lo, hi) in enumerate(rows):
            m = hi - lo
            starts[i, :m] = st.start[lo:hi]
            ends[i, :m] = st.end[lo:hi]
            orders[i, :m] = st.order[lo:hi]
        return tuple(torch.from_numpy(a).to(self.device) for a in (starts, ends, orders))

    def _run(self, windows, k: int, membership: bool):
        if not windows:
            return []
        lens = [qe - qs for _, qs, qe in windows]
        L = _round_up(max(max(lens), 1), self.sp)
        rows = self._window_rows(windows, k)
        # Bucket windows by next-pow2 candidate count, so that one dense
        # window does not inflate every window's padding to the batch max.
        buckets: dict[int, list[int]] = {}
        for i, (lo, hi) in enumerate(rows):
            M = _round_up(max(_next_pow2(hi - lo), self.sp), self.sp)
            buckets.setdefault(M, []).append(i)
        results: list[np.ndarray | None] = [None] * len(windows)
        for M, idxs in sorted(buckets.items()):
            W = _round_up(len(idxs), self.dp)
            sel = idxs + [idxs[0]] * (W - len(idxs))  # pad with a repeat row
            starts, ends, orders = self._gather([rows[i] for i in sel], M)
            qs = [windows[i][1] for i in sel]
            marks = Q.coverage_marks(starts, ends, orders, qs, k, L=L, C=self.n_docs)
            if membership:
                out = Q.membership_from_marks(marks)
            else:
                out = Q.conservation_from_marks(marks, self.n_docs)
            out = out.cpu().numpy()
            for j, i in enumerate(idxs):
                results[i] = out[j, : lens[i]]
        return results

    def conservation(self, windows: list[tuple[str, int, int]], k: int) -> list[np.ndarray]:
        """Per-window int32 conservation arrays (reference memo_query.py:70)."""
        return self._run(windows, k, membership=False)

    def membership(self, windows: list[tuple[str, int, int]], k: int) -> list[np.ndarray]:
        """Per-window int8 [len, n] presence matrices (memo_query.py:67-68)."""
        return self._run(windows, k, membership=True)
