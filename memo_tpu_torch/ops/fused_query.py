"""Fused single-window query: event streams in, conservation/membership out.

Counterpart of :mod:`memo_tpu.ops.pallas_query` (its docstring derives the
method). The store keeps its rows sorted by start and, through a permutation,
by end; shadow casting (``st = start - qs``, ``ce = end - qs - (k-1)``) keeps
both orders, so every (qs, k) query reads two already-sorted event streams:

- minus stream: -1 at ``st``, in start order;
- plus stream: +1 at ``ce``, in end order.

Events left of the window enter as the host-computed ``prefix`` (coverage at
position 0, ``QueryLayout.prefix_counts``); events right of it never matter.

:func:`prepare_streams` builds the streams on the device; :func:`fused_query`
runs the hand-written CUDA kernel (``csrc/fused_query.cu``) on them, and
:func:`fused_query_reference` is its plain PyTorch version.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from memo_tpu_torch.ops import query_ops as Q

SEG = 16  # positions per scan segment of the kernel's apply pass (kSeg)
TILES = (256, 128, 64)  # position tiles the kernel is built for, widest first
MAX_SMEM_BYTES = 232_448  # dynamic shared memory one Hopper block may use


def kernel_constants(C: int) -> int:
    """Position tile T for ``C`` columns: the widest tile whose int32 coverage
    tile (T x C) plus segment sums (T/SEG x C) fits one block's shared memory."""
    for tile in TILES:
        if (tile + tile // SEG) * C * 4 <= MAX_SMEM_BYTES:
            return tile
    widest = MAX_SMEM_BYTES // ((TILES[-1] + TILES[-1] // SEG) * 4)
    raise ValueError(f"fused query supports at most {widest} columns, got C={C}")


class Streams(NamedTuple):
    """The two sorted event streams of one window. ``pos_*`` are window
    positions (dead rows parked at ``L_pad = round_up(L, tile)``), ``val_*`` are
    column+1 (0 = inert event), ``off_*[t]`` is the first event of tile t."""

    pos_m: torch.Tensor
    val_m: torch.Tensor
    off_m: torch.Tensor
    pos_p: torch.Tensor
    val_p: torch.Tensor
    off_p: torch.Tensor
    L: int
    tile: int


def prepare_streams(
    d_start, d_end, d_order, d_end_s, d_start_by_end, d_order_by_end,
    mlo: int, mhi: int, plo: int, phi: int, qs: int, k: int,
    *, M: int, L: int, C: int, tile: int,
) -> Streams:
    """Event streams of the window [qs, qs+L) at k from the placed store
    (``engine.place_store``): M rows from ``mlo`` in start order and from
    ``plo`` in end order, of which ``[mlo, mhi)`` and ``[plo, phi)`` are the
    window's candidates. A row is a live event when ``end - start < k - 1`` and
    ``0 <= order < C`` (memo_tpu/ops/pallas_query.py:270-295)."""
    l_pad = -(-max(L, 1) // tile) * tile
    nt = l_pad // tile
    idx = torch.arange(M, dtype=torch.int32, device=d_start.device)

    def stream(pos_src, start, end, order, lo, hi, shift):
        sl = slice(lo, lo + M)
        if pos_src[sl].numel() != M:
            raise ValueError(f"store tensors hold fewer than {M} rows after row {lo}")
        live = idx < (hi - lo)
        pos = torch.where(live, pos_src[sl] - shift, l_pad)
        ok = live & (end[sl] - start[sl] < k - 1) & (order[sl] >= 0) & (order[sl] < C)
        return pos, torch.where(ok, order[sl] + 1, 0)

    pos_m, val_m = stream(d_start, d_start, d_end, d_order, mlo, mhi, qs)
    pos_p, val_p = stream(d_end_s, d_start_by_end, d_end_s, d_order_by_end, plo, phi, qs + k - 1)
    bounds = torch.arange(nt + 1, dtype=torch.int32, device=d_start.device) * tile
    off_m = torch.searchsorted(pos_m, bounds, side="left", out_int32=True)
    off_p = torch.searchsorted(pos_p, bounds, side="left", out_int32=True)
    return Streams(pos_m, val_m, off_m, pos_p, val_p, off_p, L, tile)


def fused_query_reference(streams: Streams, prefix: torch.Tensor, *, n_docs: int, membership: bool):
    """Plain PyTorch version of the kernel: a diff array over [L, C] from the
    live events, a cumulative sum from ``prefix`` over positions, and the
    conservation (int32[L]) or membership (int8[L, C]) reduction. The diff
    is laid out column by column (see ``query_ops.row_cumsum``)."""
    L, C = streams.L, prefix.numel()
    flat = L * C
    diff = torch.zeros(flat + 1, dtype=torch.int32, device=prefix.device)
    for pos, val, sign in ((streams.pos_m, streams.val_m, -1), (streams.pos_p, streams.val_p, 1)):
        live = (val > 0) & (val <= C) & (pos >= 0) & (pos < L)
        idx = torch.where(live, (val.to(torch.int64) - 1) * L + pos, flat)
        diff.scatter_add_(0, idx, torch.full(idx.shape, sign, dtype=torch.int32, device=idx.device))
    cov = prefix.view(C, 1) + Q.row_cumsum(diff[:flat].view(C, L))
    marks = (cov > 0).t()
    return Q.membership_from_marks(marks) if membership else Q.conservation_from_marks(marks, n_docs)


def fused_query(streams: Streams, prefix: torch.Tensor, *, n_docs: int, membership: bool):
    """Conservation int32[L] or membership int8[L, C] of one window.

    On CUDA tensors this launches the kernel of ``csrc/fused_query.cu`` on the
    current stream and counts the launch in ``fused_query.launches``; a tensor
    the kernel does not take raises. On CPU tensors it runs
    :func:`fused_query_reference`.
    """
    tensors = (streams.pos_m, streams.val_m, streams.off_m, streams.pos_p, streams.val_p,
               streams.off_p, prefix)
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return fused_query_reference(streams, prefix, n_docs=n_docs, membership=membership)
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"fused_query needs all tensors on one CUDA device, got {devices}")
    L, C, tile = streams.L, prefix.numel(), streams.tile
    if L < 1:
        raise ValueError(f"fused_query needs a window of at least one position, got L={L}")
    nt = -(-L // tile)
    if tile != kernel_constants(C):
        raise ValueError(f"tile {tile} is not the kernel's tile {kernel_constants(C)} for C={C}")
    for t in tensors:
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError("fused_query takes contiguous 1-D int32 tensors")
    if streams.off_m.numel() != nt + 1 or streams.off_p.numel() != nt + 1:
        raise ValueError(f"tile offsets must hold nt + 1 = {nt + 1} entries")
    if streams.pos_m.shape != streams.val_m.shape or streams.pos_p.shape != streams.val_p.shape:
        raise ValueError("each stream needs as many positions as values")

    from memo_tpu_torch.ops._build import load_library

    lib = load_library()
    device = prefix.device
    delta = torch.empty((nt, C), dtype=torch.int32, device=device)
    carry = torch.empty((nt, C), dtype=torch.int32, device=device)
    if membership:
        out = torch.empty((L, C), dtype=torch.int8, device=device)
    else:
        out = torch.empty(L, dtype=torch.int32, device=device)
    with torch.cuda.device(device):  # the launch goes to the current device
        err = lib.memo_fused_query(
            *(t.data_ptr() for t in tensors), delta.data_ptr(), carry.data_ptr(), out.data_ptr(),
            L, C, tile, n_docs, int(membership), torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"fused_query launch failed: CUDA error {err} ({lib.memo_cuda_error_string(err).decode()})"
        )
    fused_query.launches += 1
    return out


fused_query.launches = 0
