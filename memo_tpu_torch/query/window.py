"""The fused kernels' window parameters, found where the placed rows are.

Counterpart of memo_tpu's ``QueryEngine._window_params`` (engine.py:385-400)
and ``QueryLayout.prefix_counts`` (store.py:253-278), which search the host
store. Here the same searches run on the device, over the rows and keys that
:func:`~memo_tpu_torch.index.placement.place_columns` left there, so nothing
per row comes back to the host. For Q windows [qs, qs + L) of record r at k:

- ``mlo``, ``mhi``: ``searchsorted(start, qs, "right")`` and ``(start,
  qs + L, "left")`` over the record's rows in start order;
- ``plo``, ``phi``: ``(end, qs + k - 1, "right")`` and ``(end, qs + L + k -
  1, "left")`` over its rows in end order;
- the prefix, each column's coverage entering position 0: on a monotone
  store, ``#e_keys <= seg * stride + min(qs + k - 1, stride - 1)`` less
  ``#s_keys <= seg * stride + qs``, at least 0, for the record's segments of
  columns 1..C-1 (column 0 is 0); on any other store a scan of the record's
  rows, ``end <= qs + k - 1`` and ``start > qs``, counted by order, orders
  outside [0, C) dropped.

:func:`window_params` launches the kernel of ``csrc/window_params.cu`` on
the card; its plain version, :func:`window_params_reference`, does the same
searches as torch operations, and runs on the CPU. Both are held to
:func:`window_params_numpy`, the numpy searches above, by the tests and
``chip_smoke.py``. Both search ``side="right"`` only: over integers,
``searchsorted(a, v, "left")`` is ``searchsorted(a, v - 1, "right")``. The
kernel compares in 64 bits; the plain version clamps its range probes into
int32, which finds what the unclamped probe would, since every placed
coordinate lies above int32's least value (placement checks it), and keeps
``torch.searchsorted`` from promoting the record's rows to int64.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from memo_tpu_torch.index.placement import I32, DeviceLayout, PlacedStore
from memo_tpu_torch.index.store import IntervalStore, QueryLayout
from memo_tpu_torch.ops._build import launch, load_library
from memo_tpu_torch.ops.fused_query import Offsets, launch_error, upload

SCAN_PAIRS = 1 << 24  # (window, row) pairs one step of the scan fallback holds


class WindowParams(NamedTuple):
    """A launch's inputs on the device, and what the host reads of them."""

    params: torch.Tensor  # int32[Q, 5]: mlo, mhi, plo, phi, qs
    prefix: torch.Tensor  # int32[Q, C]
    counts: torch.Tensor  # int32[2, Q]: mhi - mlo and phi - plo


def _views(out: torch.Tensor, n_win: int, C: int) -> WindowParams:
    """The kernel's output buffer int32[Q * (7 + C)] as its three parts:
    params [Q, 5], prefix [Q, C] and counts [2, Q], contiguous views."""
    return WindowParams(out.as_strided((n_win, 5), (5, 1)),
                        out.as_strided((n_win, C), (C, 1), 7 * n_win),
                        out.as_strided((2, n_win), (n_win, 1), 5 * n_win))


@functools.cache
def inline_starts() -> int:
    """How many window starts the kernel of ``csrc/window_params.cu`` takes
    by value, in what its 4 KB of parameters leave (``kInlineStarts``)."""
    return load_library().memo_window_inline_starts()


def _clamp32(values: np.ndarray) -> np.ndarray:
    return np.clip(values, I32.min, I32.max)


def window_params(placed: PlacedStore, layout: DeviceLayout, r: int, starts, L: int,
                  k: int) -> WindowParams:
    """The parameters of windows [qs, qs + L) of record ``r`` at ``k``, for
    each ``qs`` of ``starts`` (a [Q] integer tensor or sequence on the
    host, or an int64 tensor already on the store's device, as
    :func:`ragged_table` leaves it), found where the placed store is;
    nothing is read back.

    On CUDA tensors this launches the kernel of ``csrc/window_params.cu``
    (one block a window) on the current stream, with up to
    :func:`inline_starts` starts from the host by value in its parameters
    and more copied up first, and counts the launch in
    ``window_params.launches``; on CPU tensors it runs
    :func:`window_params_reference`. Any other device raises."""
    device = placed.start.device
    if device.type == "cpu":
        return window_params_reference(placed, layout, r, starts, L, k)
    if device.type != "cuda":
        raise ValueError(f"window_params needs a CUDA or CPU device, got {device}")
    uploaded = isinstance(starts, torch.Tensor) and starts.device == device
    if uploaded:
        if starts.dtype != torch.int64 or starts.dim() != 1 or not starts.is_contiguous():
            raise ValueError("window_params takes starts on the device as a contiguous int64[Q]")
    else:
        starts = np.array(starts, np.int64).reshape(-1)
    n_win, C = starts.numel() if uploaded else starts.size, layout.n_docs
    rec_lo, rec_hi = int(layout.rec_offsets[r]), int(layout.rec_offsets[r + 1])
    rows, keys = placed[:4], (layout.s_keys, layout.e_keys)
    if (any(t.device != device or not t.is_contiguous() for t in rows + keys)
            or any(t.dtype != torch.int32 for t in rows) or any(t.dtype != torch.int64 for t in keys)
            or not 1 <= n_win < 1 << 31 or not 0 <= rec_lo <= rec_hi <= placed.start.numel() < 1 << 31):
        raise ValueError("window_params takes 1 to 2**31 - 1 windows over the placed store's "
                         "contiguous int32 rows (fewer than 2**31) and int64 keys, on one device")
    if uploaded:
        on_card, by_value = starts, None
    elif n_win <= inline_starts():
        on_card, by_value = None, (ctypes.c_int64 * n_win)(*starts.tolist())
    else:
        on_card, by_value = upload(starts, device), None
    out = torch.empty(n_win * (7 + C), dtype=torch.int32, device=device)
    lib = load_library()
    err = launch(
        lib.memo_window_params, device, *(t.data_ptr() for t in rows + keys),
        None if on_card is None else on_card.data_ptr(), by_value, out.data_ptr(), rec_lo,
        rec_hi - rec_lo, layout.s_keys.numel(), L, k, layout.key_stride, r * C * layout.key_stride,
        n_win, C, int(layout.monotone),
    )
    if err != 0:
        raise launch_error("window_params", lib, err)
    window_params.launches += 1
    return _views(out, n_win, C)


window_params.launches = 0


def ragged_table(starts, lengths, device) -> tuple[torch.Tensor, Offsets]:
    """A ragged batch's window starts and output offsets on ``device``, in
    one upload (:func:`~memo_tpu_torch.ops.fused_query.upload`) of one int64
    host array, the starts then the offsets: the starts for
    :func:`window_params` (int64[Q]) and the kernels' offsets
    (int64[Q + 1], from 0), both views of the one device tensor."""
    n_win = len(starts)
    host = np.empty(2 * n_win + 1, np.int64)
    host[:n_win] = starts
    host[n_win] = 0
    np.cumsum(lengths, out=host[n_win + 1 :])
    table = upload(host, torch.device(device))
    return table[:n_win], Offsets(host[n_win:], table[n_win:])


def window_params_reference(placed: PlacedStore, layout: DeviceLayout, r: int, starts, L: int,
                            k: int) -> WindowParams:
    """Plain PyTorch version of :func:`window_params`, on the placed store's
    device: one copy of the starts up (none where they are a tensor there
    already), then the four range searches and the prefix's (or the scan)
    as torch operations, written into one int32 tensor laid out as the
    kernel's (params, counts, prefix)."""
    device = placed.start.device
    if isinstance(starts, torch.Tensor):
        qs = starts.reshape(-1).to(device, torch.int64)
    else:
        qs = torch.from_numpy(np.asarray(starts, np.int64).reshape(-1)).to(device)
    n_win, C = qs.numel(), layout.n_docs
    rec_lo, rec_hi = int(layout.rec_offsets[r]), int(layout.rec_offsets[r + 1])
    wp = _views(torch.empty(n_win * (7 + C), dtype=torch.int32, device=device), n_win, C)

    probes = torch.stack([qs, qs + (L - 1), qs + (k - 1), qs + (L + k - 2)])
    probes = probes.clamp_(I32.min, I32.max).to(torch.int32)
    found = torch.cat([
        torch.searchsorted(placed.start[rec_lo:rec_hi], probes[:2], right=True, out_int32=True),
        torch.searchsorted(placed.end_s[rec_lo:rec_hi], probes[2:], right=True, out_int32=True),
    ])
    torch.sub(found[1::2], found[0::2], out=wp.counts)
    wp.params[:, :4] = (found + rec_lo).t()
    wp.params[:, 4] = qs

    wp.prefix.zero_()
    if layout.monotone:
        if C > 1:
            stride = layout.key_stride
            first_key = r * C * stride  # key of record r's column 0 at coordinate 0
            cols = torch.arange(first_key + stride, first_key + C * stride, stride,
                                dtype=torch.int64, device=device)
            e_probes = (qs + (k - 1)).clamp_(max=stride - 1)[:, None] + cols
            ends = torch.searchsorted(layout.e_keys, e_probes, right=True, out_int32=True)
            begins = torch.searchsorted(layout.s_keys, qs[:, None] + cols, right=True,
                                        out_int32=True)
            wp.prefix[:, 1:] = (ends - begins).clamp_(min=0)
    elif rec_hi > rec_lo:
        _scan_prefix(placed, rec_lo, rec_hi, qs + (k - 1), qs, wp.prefix)
    return wp


def _scan_prefix(placed: PlacedStore, rec_lo: int, rec_hi: int, e0: torch.Tensor,
                 starts: torch.Tensor, prefix: torch.Tensor) -> None:
    """The prefix of a store the keys do not serve: per window, the record's
    rows with ``end <= e0`` and ``start > qs``, counted by order into
    ``prefix`` [Q, C], orders outside [0, C) dropped (into a sink column C
    that is cut off)."""
    n_win, C = prefix.shape
    s, e, o = (t[rec_lo:rec_hi] for t in (placed.start, placed.end, placed.order))
    column = torch.where((o >= 0) & (o < C), o, C).to(torch.int64)
    step = max(1, SCAN_PAIRS // s.numel())
    for w0 in range(0, n_win, step):
        hit = (e <= e0[w0 : w0 + step, None]) & (s > starts[w0 : w0 + step, None])  # [g, rows]
        slot = torch.arange(hit.shape[0], device=s.device)[:, None] * (C + 1)
        slot = torch.where(hit, slot + column, slot + C).reshape(-1)
        tally = torch.zeros(hit.shape[0] * (C + 1), dtype=torch.int32, device=s.device)
        tally.scatter_add_(0, slot, torch.ones(slot.shape, dtype=torch.int32, device=s.device))
        prefix[w0 : w0 + step] = tally.view(-1, C + 1)[:, :C]


def window_bounds(placed: PlacedStore, layout: DeviceLayout, r: int, qs: int, qe: int,
                  k: int) -> tuple[int, int]:
    """``IntervalStore.window_bounds`` over the placed rows: the rows [lo, hi)
    of record ``r`` whose start lies in [qs - longest, qe + k), found on the
    device; the two bounds are read back."""
    rec_lo, rec_hi = int(layout.rec_offsets[r]), int(layout.rec_offsets[r + 1])
    probes = _clamp32(np.array([qs - int(layout.longest[r]) - 1, qe + k - 1], np.int64))
    found = torch.searchsorted(placed.start[rec_lo:rec_hi],
                               torch.from_numpy(probes.astype(np.int32)).to(placed.start.device),
                               right=True)
    lo, hi = found.tolist()
    return rec_lo + lo, rec_lo + hi


def window_params_numpy(store: IntervalStore, layout: QueryLayout, r: int, starts, L: int,
                        k: int) -> tuple[np.ndarray, np.ndarray]:
    """Plain version of :func:`window_params` on the host store and its
    numpy layout (the port's engine before the search moved to the device,
    memo_tpu's ``_window_params``): params int64[Q, 5] and prefix
    int64[Q, C]."""
    rec_lo, rec_hi = int(store.rec_offsets[r]), int(store.rec_offsets[r + 1])
    seg_s = store.start[rec_lo:rec_hi]
    seg_e = layout.end_sorted[rec_lo:rec_hi]
    params, prefix = [], []
    for qs in np.asarray(starts, np.int64).reshape(-1).tolist():
        params.append((
            rec_lo + int(np.searchsorted(seg_s, qs, side="right")),
            rec_lo + int(np.searchsorted(seg_s, qs + L, side="left")),
            rec_lo + int(np.searchsorted(seg_e, qs + k - 1, side="right")),
            rec_lo + int(np.searchsorted(seg_e, qs + L + k - 1, side="left")),
            qs,
        ))
        prefix.append(layout.prefix_counts(store, r, qs, k))
    return (np.array(params, np.int64).reshape(-1, 5),
            np.array(prefix, np.int64).reshape(len(params), store.n_docs))
