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

One launch takes at most :data:`MAX_WINDOWS` windows and the columns one
block's shared memory holds (:data:`MAX_COLUMNS`; v2's own); the wrappers
take any Q and any C by launching groups (:func:`launch_groups`). A
launch covers a group of columns ``[c0, c0 + G)`` of the store's C: rows
of other columns are no events, membership fills those G columns of the
[Q, L, C] output, and conservation is c0 plus the group's first marked
column, or ``n_docs``, min-combined into the output, so that after the
last group it holds the store's.
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
MAX_WINDOWS = 65_535  # windows of one launch: v1 puts the window on grid axis y
# Columns of one v1 launch: the widest C that kernel_constants takes (854).
MAX_COLUMNS = MAX_SMEM_BYTES // ((TILES[-1] + TILES[-1] // SEG) * 4)
CPU = torch.device("cpu")


def kernel_constants(C: int) -> int:
    """Position tile T for ``C`` columns at which the plain version builds
    its streams: the widest tile whose int32 (T x C) tile plus segment sums
    (T/SEG x C) fits one block. It bounds the widths one v1 launch takes
    (C <= MAX_COLUMNS = 854)."""
    for tile in TILES:
        if (tile + tile // SEG) * C * 4 <= MAX_SMEM_BYTES:
            return tile
    raise ValueError(f"fused query supports at most {MAX_COLUMNS} columns, got C={C}")


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
    *, M: int, L: int, C: int, tile: int, c0: int = 0,
) -> Streams:
    """Event streams of windows [qs, qs+L) at k from the placed store
    (``engine.place_store``): M rows from ``mlo`` in start order and from
    ``plo`` in end order, of which ``[mlo, mhi)`` and ``[plo, phi)`` are the
    window's candidates, and the rest dead, also where they would lie past
    the placed rows. A row is a live event when ``end - start < k - 1`` and
    ``c0 <= order < c0 + C`` (memo_tpu/ops/pallas_query.py:270-295), in
    column ``order - c0``: the streams of the column group [c0, c0 + C).

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
        ok = live & (e - s < k - 1) & (o >= c0) & (o < c0 + C)
        return pos, torch.where(ok, o - c0 + 1, 0)

    pos_m, val_m = stream(d_start, d_end, d_order, mlo, mhi, qs, True)
    pos_p, val_p = stream(d_start_by_end, d_end_s, d_order_by_end, plo, phi, qs + k - 1, False)
    off_m = torch.searchsorted(pos_m, bounds, side="left", out_int32=True)
    off_p = torch.searchsorted(pos_p, bounds, side="left", out_int32=True)
    parts = (pos_m, val_m, off_m, pos_p, val_p, off_p)
    if batched and n_win == 1:
        parts = tuple(t[None] for t in parts)
    return Streams(*parts, L, tile)


def fused_query_reference(streams: Streams, prefix: torch.Tensor, *, n_docs: int, membership: bool,
                          c0: int = 0):
    """Plain PyTorch version of the kernel: a diff array over [Q, C, L] from
    the live events, a cumulative sum from ``prefix`` over positions, and the
    conservation (int32[L] or [Q, L]) or membership (int8[L, C] or
    [Q, L, C]) reduction, for 1-D or batched streams. The diff is laid out
    window by window and column by column (see ``query_ops.row_cumsum``);
    dead events add into sink slots of their own past it
    (``query_ops.coverage_counts`` says why). Streams of the column group
    from ``c0`` (:func:`prepare_streams`) give conservation as the kernel
    writes it: ``c0`` plus the group's first marked column, or ``n_docs``."""
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
    if membership:
        out = Q.membership_from_marks(marks)
    else:
        out = Q.conservation_from_marks(marks, n_docs - c0)
        out = out + c0 if c0 else out
    return out if batched else out[0]


def check_rows_launch(name: str, placed, params: torch.Tensor, prefix: torch.Tensor, *, k: int,
                      L: int, C: int) -> int | None:
    """Validate a call on the placed store's six row tensors, the parameter
    block [Q, 5] (any Q >= 1) and the prefix [Q, C]: returns the rows per
    store tensor, or None where every tensor is on the CPU (the plain
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
    if params.shape != (n_win, 5) or n_win < 1:
        raise ValueError(f"params must be [Q, 5] with Q >= 1, got {tuple(params.shape)}")
    if prefix.shape != (n_win, C):
        raise ValueError(f"prefix must be [Q, C] = [{n_win}, {C}], got {tuple(prefix.shape)}")
    n_rows = placed[0].numel()
    for t in tensors:
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous int32 tensors")
    if any(t.dim() != 1 or t.numel() != n_rows for t in placed) or n_rows >= 2**31:
        raise ValueError("the placed store needs six 1-D row tensors of one length below 2**31")
    return n_rows


def output_tensor(lead: tuple, L: int, C: int, membership: bool, device) -> torch.Tensor:
    if membership:
        return torch.empty(lead + (L, C), dtype=torch.int8, device=device)
    return torch.empty(lead + (L,), dtype=torch.int32, device=device)


def launch_error(name: str, lib, err: int) -> RuntimeError:
    return RuntimeError(
        f"{name} launch failed: CUDA error {err} ({lib.memo_cuda_error_string(err).decode()})"
    )


def launch_groups(launch_group, placed, params, prefix, n_rows, *, widest: int, k: int, L: int,
                  C: int, n_docs: int, membership: bool) -> torch.Tensor:
    """A wrapper's call as launches of ``launch_group`` over groups of at
    most :data:`MAX_WINDOWS` consecutive windows (rows of ``params`` and
    ``prefix``, no copy) and of at most ``widest`` columns (as few as fit,
    of equal width), each into its rows of the one output, which it
    returns. Membership groups fill their columns; a conservation group
    from c0 > 0 writes the minimum of the output and its own (launches run
    in stream order). A call that fits one launch is that launch alone.
    Both limits are read here, at the call."""
    n_win = params.shape[0]
    out = output_tensor((n_win,), L, C, membership, params.device)
    G = -(-C // -(-C // widest))
    for g0 in range(0, n_win, MAX_WINDOWS):
        rows = slice(g0, g0 + MAX_WINDOWS)  # one group of every window takes the tensors as given
        part = (params, prefix, out) if n_win <= MAX_WINDOWS else (params[rows], prefix[rows],
                                                                    out[rows])
        for c0 in range(0, C, G):
            launch_group(placed, *part, n_rows, k=k, L=L, C=C, c0=c0, G=min(G, C - c0),
                         n_docs=n_docs, membership=membership)
    return out


def fused_query_rows_reference(placed, params, prefix, *, k: int, L: int, C: int, n_docs: int,
                               membership: bool, c0: int = 0, G: int | None = None):
    """Plain PyTorch version of :func:`fused_query_rows`, over the column
    group [c0, c0 + G) (all C columns by default): the event streams of
    every window (:func:`prepare_streams`, over as many rows as the largest
    candidate range) and their diff-array query
    (:func:`fused_query_reference`) from the group's prefix columns. Output
    [Q, L] (c0 plus the group's first marked column, or ``n_docs``), or
    [Q, L, G] for membership: the group's columns alone. It takes any
    width: the tile only lays out the streams."""
    G = C - c0 if G is None else G
    mlo, mhi, plo, phi, qs = params.cpu().numpy().astype(np.int64).T
    M = max(int((mhi - mlo).max()), int((phi - plo).max()), 1)
    tile = kernel_constants(G) if G <= MAX_COLUMNS else TILES[-1]
    streams = prepare_streams(*placed, mlo, mhi, plo, phi, qs, k, M=M, L=L, C=G, tile=tile, c0=c0)
    return fused_query_reference(streams, prefix[:, c0 : c0 + G], n_docs=n_docs,
                                 membership=membership, c0=c0)


def plain_group(placed, params, prefix, out, *, k: int, L: int, C: int, c0: int, G: int,
                n_docs: int, membership: bool) -> None:
    """A launch's plain version (CPU tensors): the column group
    [c0, c0 + G) of ``params``' windows into ``out`` as the kernels write
    it (:func:`launch_groups`)."""
    got = fused_query_rows_reference(placed, params, prefix, k=k, L=L, C=C, n_docs=n_docs,
                                     membership=membership, c0=c0, G=G)
    if membership:
        out[..., c0 : c0 + G] = got
    elif c0:
        torch.minimum(out, got, out=out)
    else:
        out.copy_(got)


def _launch_group(placed, params, prefix, out, n_rows, *, k: int, L: int, C: int, c0: int, G: int,
                  n_docs: int, membership: bool) -> None:
    """One launch of the kernels of ``csrc/fused_query.cu`` over
    ``params``' windows and the column group [c0, c0 + G) into ``out``
    (:func:`launch_groups`), counted in ``fused_query_rows.launches``; its
    plain version where ``n_rows`` is None (CPU tensors)."""
    if n_rows is None:
        return plain_group(placed, params, prefix, out, k=k, L=L, C=C, c0=c0, G=G,
                           n_docs=n_docs, membership=membership)
    n_win = params.shape[0]
    tile = rows_tile(G)
    lib = load_library()
    device = params.device
    nt = -(-L // tile)
    scratch = torch.empty(n_win * nt * (4 + 2 * G), dtype=torch.int32, device=device)
    err = launch(lib.memo_fused_query_rows, device,
                 *(t.data_ptr() for t in (*placed, params, prefix)), scratch.data_ptr(),
                 out.data_ptr(), n_rows, n_win, L, C, c0, G, k, tile, n_docs, int(membership))
    if err != 0:
        raise launch_error("fused_query_rows", lib, err)
    fused_query_rows.launches += 1


def fused_query_rows(placed, params: torch.Tensor, prefix: torch.Tensor, *, k: int, L: int, C: int,
                     n_docs: int, membership: bool):
    """Conservation int32[Q, L] or membership int8[Q, L, C] of Q windows of
    L positions at k, from the placed store (``engine.PlacedStore``, six
    int32 row tensors), the parameter block ``params`` int32[Q, 5] and the
    prefix int32[Q, C] (``query/window.py`` finds both on the device), for
    any Q and any C.

    On CUDA tensors this launches the kernels of ``csrc/fused_query.cu`` on
    the current stream, once where the call fits one launch, else once per
    window and column group (:func:`launch_groups`), and counts each launch
    in ``fused_query_rows.launches``; a tensor the kernels do not take
    raises. On CPU tensors each group runs
    :func:`fused_query_rows_reference`.
    """
    n_rows = check_rows_launch("fused_query_rows", placed, params, prefix, k=k, L=L, C=C)
    return launch_groups(_launch_group, placed, params, prefix, n_rows, widest=MAX_COLUMNS, k=k,
                         L=L, C=C, n_docs=n_docs, membership=membership)


fused_query_rows.launches = 0
