"""Diff-array formulation of the MEMO query on PyTorch tensors.

Counterpart of :mod:`memo_tpu.ops.query_ops` (see its docstring for the proof
that the formulation equals the reference's per-interval slice writes):

    coverage[p, c] = #{intervals i: order_i == c and ce_i <= p < st_i}
                   = cumsum_p( +1 at ce_i, -1 at st_i )
    marked = coverage > 0        # "k-mer at p absent from column c"

These are plain tensor ops on whatever device the inputs live on. They back
the engine's ``torch`` backend and its over-cap fallback
(``QueryEngine._query_interval_pieces``), and the one-device strategies of
:mod:`memo_tpu_torch.parallel`, which run many windows at once: where
memo_tpu maps ``coverage_counts`` over windows with ``jax.vmap``, the window
batch here is a leading dimension of the inputs. The numpy twins at the
bottom back the ``numpy`` backend.
"""

from __future__ import annotations

import numpy as np
import torch


def cast_and_clip(starts, ends, qs: int, L: int, k: int):
    """Recenter to the window, shadow-cast by k-1, clip to [0, L]
    (reference memo_init, memo_query.py:42-49). Returns (st, ce, valid)."""
    st = torch.clamp(starts - qs, 0, L)
    ce = torch.clamp(ends - qs - (k - 1), 0, L)
    return st, ce, ce < st


def row_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 cumulative sum along each row of a contiguous [R, n]
    tensor: one flat 1-D scan, minus for each row the total of the rows
    before it. ``torch.cumsum`` along the outer dim of a narrow tensor (the
    position axis of an [L, C] diff) runs one CUDA thread per column and
    takes most of a second at L = 2M; the flat scan does not."""
    R, n = x.shape
    flat = torch.cumsum(x.reshape(-1), dim=0, dtype=torch.int32).view(R, n)
    before = torch.zeros((R, 1), dtype=torch.int32, device=x.device)
    before[1:, 0] = flat[:-1, -1]
    return flat - before


def coverage_counts(starts, ends, orders, qs, k: int, *, L: int, C: int) -> torch.Tensor:
    """int32 interval-coverage counts: [L, C] for one window, [W, L, C] for W.

    ``starts/ends/orders`` are int tensors of candidate intervals in absolute
    pivot coordinates, [M] for one window at ``qs`` (an int) or [W, M] for W
    windows at ``qs`` (an int, or W ints as a sequence or tensor). Rows
    outside their window clip to empty. The diff is laid out window by window
    and column by column, (L+1) positions each, so that the scan over
    positions runs along rows (:func:`row_cumsum`).

    Rows with an order outside [0, C) are dropped: each one adds into a sink
    slot of its own, in a sink region as wide as the input past the diff. A
    single shared sink slot (memo_tpu's ``mode="drop"``) puts every dropped
    row's atomic add on one address, which serialised millions of them on a
    GPU; compacting the live rows instead would cost a device-to-host sync
    for their count, and the sink keeps every shape static.
    """
    batched = starts.dim() == 2
    if not batched:
        starts, ends, orders = starts[None], ends[None], orders[None]
    W, M = starts.shape
    dev = starts.device
    if not isinstance(qs, int):
        qs = torch.as_tensor(qs, dtype=torch.int64, device=dev).reshape(-1, 1)
    st, ce, valid = cast_and_clip(starts, ends, qs, L, k)
    order = orders.to(torch.int64)
    ok = valid & (order >= 0) & (order < C)
    flat_size = W * C * (L + 1)
    row = (torch.arange(W, dtype=torch.int64, device=dev)[:, None] * C + order) * (L + 1)
    sink = flat_size + torch.arange(W * M, dtype=torch.int64, device=dev).view(W, M)
    idx_plus = torch.where(ok, row + ce, sink)
    idx_minus = torch.where(ok, row + st, sink)
    diff = torch.zeros(flat_size + W * M, dtype=torch.int32, device=dev)
    ones = torch.ones(W * M, dtype=torch.int32, device=dev)
    diff.scatter_add_(0, idx_plus.view(-1), ones)
    diff.scatter_add_(0, idx_minus.view(-1), -ones)
    counts = row_cumsum(diff[:flat_size].view(W * C, L + 1)).view(W, C, L + 1)
    counts = counts[:, :, :L].transpose(1, 2).contiguous()
    return counts if batched else counts[0]


def coverage_marks(starts, ends, orders, qs, k: int, *, L: int, C: int) -> torch.Tensor:
    """bool[L, C] (or [W, L, C]) absence marks (counts > 0)."""
    return coverage_counts(starts, ends, orders, qs, k, L=L, C=C) > 0


def conservation_from_marks(marks: torch.Tensor, n_docs: int) -> torch.Tensor:
    """int32[...] conservation values of bool[..., C] marks: first marked
    column, else n_docs (== reference argmax with sentinel column,
    memo_query.py:52-54,70)."""
    cols = torch.arange(marks.shape[-1], dtype=torch.int32, device=marks.device)
    vals = torch.where(marks, cols, n_docs)
    return torch.clamp(vals.amin(dim=-1), max=n_docs)


def membership_from_marks(marks: torch.Tensor) -> torch.Tensor:
    """int8[..., C] presence matrix (row-major); column 0 (pivot) is always 1."""
    return (~marks).to(torch.int8).contiguous()


def conservation_window(starts, ends, orders, qs: int, k: int, *, L: int, C: int, n_docs: int):
    return conservation_from_marks(coverage_marks(starts, ends, orders, qs, k, L=L, C=C), n_docs)


def membership_window(starts, ends, orders, qs: int, k: int, *, L: int, C: int):
    return membership_from_marks(coverage_marks(starts, ends, orders, qs, k, L=L, C=C))


# ----------------------------------------------------------------- numpy path
def coverage_marks_np(starts, ends, orders, qs: int, k: int, L: int, C: int) -> np.ndarray:
    """Host twin of :func:`coverage_marks` (the ``numpy`` backend)."""
    starts = np.asarray(starts, np.int64)
    ends = np.asarray(ends, np.int64)
    orders = np.asarray(orders, np.int64)
    st = np.clip(starts - qs, 0, L)
    ce = np.clip(ends - qs - (k - 1), 0, L)
    ok = (ce < st) & (orders >= 0) & (orders < C)
    diff = np.zeros((L + 1, C), np.int32)
    np.add.at(diff, (ce[ok], orders[ok]), 1)
    np.add.at(diff, (st[ok], orders[ok]), -1)
    return np.cumsum(diff[:L], axis=0) > 0


def conservation_np(marks: np.ndarray, n_docs: int) -> np.ndarray:
    L, C = marks.shape
    vals = np.where(marks, np.arange(C, dtype=np.int64)[None, :], n_docs)
    return np.minimum(vals.min(axis=1), n_docs).astype(np.int64)


def membership_np(marks: np.ndarray) -> np.ndarray:
    return (~marks).astype(np.int8)
