"""Fused query: the placed store's rows in, conservation/membership out.

Counterpart of :mod:`memo_tpu.ops.pallas_query` (its docstring derives the
method). The store keeps its rows sorted by start and, through a permutation,
by end; shadow casting (``st = start - qs``, ``ce = end - qs - (k-1)``) keeps
both orders, so every (qs, k) query reads two already-sorted event streams:

- minus stream: -1 at ``st``, in start order;
- plus stream: +1 at ``ce``, in end order.

Events left of the window enter as the ``prefix`` (coverage at position 0,
``QueryLayout.prefix_counts``, found on the device by ``query/window.py``);
events right of it never matter.

:func:`fused_query_rows` runs the hand-written CUDA kernel
(``csrc/fused_query.cu``) on the store's rows as ``engine.place_store`` put
them on the device, for one window or a batch, from one int32 [Q, 5]
parameter block (mlo, mhi, plo, phi, qs) and the prefix [Q, C]; the kernel
finds each tile's rows itself. Its plain PyTorch version is
:func:`prepare_streams` (the streams as memo_query_pallas builds them, over
M rows from ``mlo`` and ``plo``) followed by :func:`fused_query_reference`.
The v2 kernel (:mod:`memo_tpu_torch.ops.fused_query_v2`) has the same
contract and the same plain version.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from memo_tpu_torch.ops import query_ops as Q
from memo_tpu_torch.ops._build import launch, load_library

SEG = 16  # segment sums in kernel_constants' tile budget, which sets v1's widest C
TILES = (256, 128, 64)  # position tiles the kernels are built for, widest first
MAX_SMEM_BYTES = 232_448  # dynamic shared memory one Hopper block may use
MAX_WINDOWS = 65_535  # the kernels put the window on grid axis y
CPU = torch.device("cpu")


def kernel_constants(C: int) -> int:
    """Position tile T for ``C`` columns at which the plain version builds
    its streams: the widest tile whose int32 (T x C) tile plus segment sums
    (T/SEG x C) fits one block. It bounds the widths v1 takes (C <= 854)."""
    for tile in TILES:
        if (tile + tile // SEG) * C * 4 <= MAX_SMEM_BYTES:
            return tile
    widest = MAX_SMEM_BYTES // ((TILES[-1] + TILES[-1] // SEG) * 4)
    raise ValueError(f"fused query supports at most {widest} columns, got C={C}")


def _rows_smem_bytes(tile: int, C: int) -> int:
    """Shared memory of one block of the apply pass (csrc/fused_query.cu):
    the tile int32[C][tile + 1], the carry [C] and the first marked column
    of each position [tile]."""
    return (C * (tile + 1) + C + tile) * 4


@functools.lru_cache(maxsize=None)
def rows_tile(C: int) -> int:
    """Position tile of the row kernel for ``C`` columns: the widest of
    256/128/64 whose shared memory fits one block. Takes every C that v1
    took before it (:func:`kernel_constants` raises past that)."""
    kernel_constants(C)
    return next(tile for tile in TILES if _rows_smem_bytes(tile, C) <= MAX_SMEM_BYTES)


class Streams(NamedTuple):
    """The two sorted event streams of one window (1-D tensors) or of Q
    windows (one row each). ``pos_*`` are window positions (dead rows parked
    at ``L_pad = round_up(L, tile)``), ``val_*`` are column+1 (0 = inert
    event), ``off_*[..., t]`` is the first event of tile t."""

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
    mlo, mhi, plo, phi, qs, k: int,
    *, M: int, L: int, C: int, tile: int,
) -> Streams:
    """Event streams of windows [qs, qs+L) at k from the placed store
    (``engine.place_store``): M rows from ``mlo`` in start order and from
    ``plo`` in end order, of which ``[mlo, mhi)`` and ``[plo, phi)`` are the
    window's candidates, and the rest dead, also where they would lie past
    the placed rows. A row is a live event when ``end - start < k - 1`` and
    ``0 <= order < C`` (memo_tpu/ops/pallas_query.py:270-295).

    ``mlo, mhi, plo, phi, qs`` are ints for one window, which gives 1-D
    streams and tile offsets [nt + 1], or equal-length sequences for Q
    windows, which gives [Q, M] streams and [Q, nt + 1] offsets; every window
    of a batch runs at the same L (memo_tpu engine.py:316-353)."""
    batched = np.ndim(mlo) == 1
    dev = d_start.device
    l_pad = -(-max(L, 1) // tile) * tile
    nt = l_pad // tile
    idx = torch.arange(M, dtype=torch.int32, device=dev)
    bounds = torch.arange(nt + 1, dtype=torch.int32, device=dev) * tile
    n_win = len(mlo) if batched else 1
    n_rows = d_start.numel()
    if n_win > 1:
        mlo, mhi, plo, phi, qs = (np.asarray(x, np.int64) for x in (mlo, mhi, plo, phi, qs))
        bounds = bounds.expand(n_win, nt + 1).contiguous()

        def per_window(x):
            return torch.from_numpy(x.astype(np.int32)).to(dev)[:, None]
    else:
        if batched:
            mlo, mhi, plo, phi, qs = (int(x[0]) for x in (mlo, mhi, plo, phi, qs))

        def per_window(x):
            return x

    def row_reader(lo):
        """The M rows from ``lo`` (each window's), one index for a stream's
        columns. Rows past the placed ones lie past ``hi`` and are dead: the
        last placed row is read in their place."""
        rows = (torch.as_tensor(lo, device=dev)[..., None] + idx).clamp_(max=n_rows - 1)
        return lambda src: src[rows]

    def stream(start, end, order, lo, hi, shift, by_start):
        read = row_reader(lo)
        s, e, o = read(start), read(end), read(order)
        live = idx < per_window(hi - lo)
        pos = torch.where(live, (s if by_start else e) - per_window(shift), l_pad)
        ok = live & (e - s < k - 1) & (o >= 0) & (o < C)
        return pos, torch.where(ok, o + 1, 0)

    pos_m, val_m = stream(d_start, d_end, d_order, mlo, mhi, qs, True)
    pos_p, val_p = stream(d_start_by_end, d_end_s, d_order_by_end, plo, phi, qs + k - 1, False)
    off_m = torch.searchsorted(pos_m, bounds, side="left", out_int32=True)
    off_p = torch.searchsorted(pos_p, bounds, side="left", out_int32=True)
    parts = (pos_m, val_m, off_m, pos_p, val_p, off_p)
    if batched and n_win == 1:
        parts = tuple(t[None] for t in parts)
    return Streams(*parts, L, tile)


def fused_query_reference(streams: Streams, prefix: torch.Tensor, *, n_docs: int, membership: bool):
    """Plain PyTorch version of the kernel: a diff array over [Q, C, L] from
    the live events, a cumulative sum from ``prefix`` over positions, and the
    conservation (int32[L] or [Q, L]) or membership (int8[L, C] or
    [Q, L, C]) reduction, for 1-D or batched streams. The diff is laid out
    window by window and column by column (see ``query_ops.row_cumsum``);
    dead events add into sink slots of their own past it
    (``query_ops.coverage_counts`` says why)."""
    batched = streams.pos_m.dim() == 2
    L, C = streams.L, prefix.shape[-1]
    prefix = prefix.reshape(-1, C)
    n_win = prefix.shape[0]
    dev = prefix.device
    flat = n_win * C * L
    n_events = streams.pos_m.numel() + streams.pos_p.numel()
    diff = torch.zeros(flat + n_events, dtype=torch.int32, device=dev)
    window = torch.arange(n_win, dtype=torch.int64, device=dev)[:, None]
    sink = flat
    for pos, val, sign in ((streams.pos_m, streams.val_m, -1), (streams.pos_p, streams.val_p, 1)):
        pos, val = pos.reshape(n_win, -1), val.reshape(n_win, -1)
        live = (val > 0) & (val <= C) & (pos >= 0) & (pos < L)
        slots = sink + torch.arange(pos.numel(), dtype=torch.int64, device=dev).view(pos.shape)
        idx = torch.where(live, (window * C + val - 1) * L + pos, slots)
        diff.scatter_add_(0, idx.view(-1), torch.full((idx.numel(),), sign, dtype=torch.int32, device=dev))
        sink += pos.numel()
    cov = prefix.view(n_win, C, 1) + Q.row_cumsum(diff[:flat].view(n_win * C, L)).view(n_win, C, L)
    marks = (cov > 0).transpose(1, 2)
    out = Q.membership_from_marks(marks) if membership else Q.conservation_from_marks(marks, n_docs)
    return out if batched else out[0]


def check_rows_launch(name: str, placed, params: torch.Tensor, prefix: torch.Tensor, *, k: int,
                      L: int, C: int) -> tuple[int, int] | None:
    """Validate a kernel launch on the placed store's six row tensors, the
    parameter block [Q, 5] and the prefix [Q, C]: returns (Q, rows per
    store tensor), or None where every tensor is on the CPU (the plain
    version's case). Raises on anything the kernels do not take, so that a
    CUDA tensor never reaches a plain version."""
    tensors = (*placed, params, prefix)
    devices = {t.device for t in tensors}
    if devices == {CPU}:
        return None
    if len(devices) != 1 or params.device.type != "cuda":
        raise ValueError(f"{name} needs all tensors on one CUDA device, got {devices}")
    n_win = params.shape[0] if params.dim() == 2 else 0
    if L < 1 or k < 1:
        raise ValueError(f"{name} needs L >= 1 and k >= 1, got L={L}, k={k}")
    if params.shape != (n_win, 5) or not 1 <= n_win <= MAX_WINDOWS:
        raise ValueError(
            f"params must be [Q, 5] with 1 <= Q <= {MAX_WINDOWS}, got {tuple(params.shape)}"
        )
    if prefix.shape != (n_win, C):
        raise ValueError(f"prefix must be [Q, C] = [{n_win}, {C}], got {tuple(prefix.shape)}")
    n_rows = placed[0].numel()
    for t in tensors:
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous int32 tensors")
    if any(t.dim() != 1 or t.numel() != n_rows for t in placed) or n_rows >= 2**31:
        raise ValueError("the placed store needs six 1-D row tensors of one length below 2**31")
    return n_win, n_rows


def output_tensor(lead: tuple, L: int, C: int, membership: bool, device) -> torch.Tensor:
    if membership:
        return torch.empty(lead + (L, C), dtype=torch.int8, device=device)
    return torch.empty(lead + (L,), dtype=torch.int32, device=device)


def launch_error(name: str, lib, err: int) -> RuntimeError:
    return RuntimeError(
        f"{name} launch failed: CUDA error {err} ({lib.memo_cuda_error_string(err).decode()})"
    )


def fused_query_rows_reference(placed, params, prefix, *, k: int, L: int, C: int, n_docs: int,
                               membership: bool):
    """Plain PyTorch version of :func:`fused_query_rows`: the event streams
    of every window (:func:`prepare_streams`, over as many rows as the
    largest candidate range) and their diff-array query
    (:func:`fused_query_reference`). Output [Q, L] or [Q, L, C]."""
    mlo, mhi, plo, phi, qs = params.cpu().numpy().astype(np.int64).T
    M = max(int((mhi - mlo).max()), int((phi - plo).max()), 1)
    streams = prepare_streams(*placed, mlo, mhi, plo, phi, qs, k, M=M, L=L, C=C,
                              tile=kernel_constants(C))
    return fused_query_reference(streams, prefix, n_docs=n_docs, membership=membership)


def fused_query_rows(placed, params: torch.Tensor, prefix: torch.Tensor, *, k: int, L: int, C: int,
                     n_docs: int, membership: bool):
    """Conservation int32[Q, L] or membership int8[Q, L, C] of Q windows of
    L positions at k, from the placed store (``engine.PlacedStore``, six
    int32 row tensors), the parameter block ``params`` int32[Q, 5] and the
    prefix int32[Q, C] (``query/window.py`` finds both on the device).

    On CUDA tensors this launches the kernels of ``csrc/fused_query.cu`` on
    the current stream, once for the whole batch, and counts the launch in
    ``fused_query_rows.launches``; a tensor the kernels do not take raises.
    On CPU tensors it runs :func:`fused_query_rows_reference`.
    """
    checked = check_rows_launch("fused_query_rows", placed, params, prefix, k=k, L=L, C=C)
    if checked is None:
        return fused_query_rows_reference(placed, params, prefix, k=k, L=L, C=C, n_docs=n_docs,
                                          membership=membership)
    n_win, n_rows = checked
    tile = rows_tile(C)
    lib = load_library()
    device = params.device
    nt = -(-L // tile)
    scratch = torch.empty(n_win * nt * (4 + 2 * C), dtype=torch.int32, device=device)
    out = output_tensor((n_win,), L, C, membership, device)
    err = launch(lib.memo_fused_query_rows, device,
                 *(t.data_ptr() for t in (*placed, params, prefix)), scratch.data_ptr(),
                 out.data_ptr(), n_rows, n_win, L, C, k, tile, n_docs, int(membership))
    if err != 0:
        raise launch_error("fused_query_rows", lib, err)
    fused_query_rows.launches += 1
    return out


fused_query_rows.launches = 0
