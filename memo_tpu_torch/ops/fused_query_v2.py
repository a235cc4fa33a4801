"""Fused query, v2: the one-pass kernel for dense windows.

Counterpart of :mod:`memo_tpu.ops.pallas_query_v2`, with the same contract
as v1 (:mod:`memo_tpu_torch.ops.fused_query`) and the same event streams
from ``prepare_streams``, built at v2's own tile. :func:`fused_query_v2` runs
the hand-written CUDA kernel of ``csrc/fused_query_v2.cu`` (one pass over the
events with a decoupled look-back for the carry; its source note says how
it differs from v1 and from the TPU kernel), and
:func:`fused_query_v2_reference` is its plain PyTorch version.
"""

from __future__ import annotations

import torch

from memo_tpu_torch.ops.fused_query import (
    CPU,
    MAX_SMEM_BYTES,
    TILES,
    Streams,
    check_launch,
    fused_query_reference,
    launch_error,
    output_tensor,
)


def _smem_bytes(tile: int, C: int) -> int:
    """Shared memory of one block: the transposed tile int32[C][tile + 1],
    the carry int32[C] and the block's ticket."""
    return (C * (tile + 2) + 1) * 4


def kernel_constants_v2(C: int) -> int:
    """Position tile T for ``C`` columns: the widest of 256/128/64 whose
    shared memory fits one block."""
    for tile in TILES:
        if _smem_bytes(tile, C) <= MAX_SMEM_BYTES:
            return tile
    widest = (MAX_SMEM_BYTES // 4 - 1) // (TILES[-1] + 2)
    raise ValueError(f"fused query v2 supports at most {widest} columns, got C={C}")


def fused_query_v2_reference(streams: Streams, prefix: torch.Tensor, *, n_docs: int, membership: bool):
    """Plain PyTorch version of the v2 kernel. v2 computes exactly what v1
    computes, so this is v1's diff array (:func:`fused_query_reference`); it
    is held against ``memo_query_pallas_v2`` itself by the tests."""
    return fused_query_reference(streams, prefix, n_docs=n_docs, membership=membership)


def fused_query_v2(streams: Streams, prefix: torch.Tensor, *, n_docs: int, membership: bool):
    """Conservation int32[L] / membership int8[L, C] of one window, or
    [Q, L] / [Q, L, C] of Q windows, from streams built at
    ``kernel_constants_v2(C)``.

    On CUDA tensors this launches the kernel of ``csrc/fused_query_v2.cu`` on
    the current stream, once for the whole batch, and counts the launch in
    ``fused_query_v2.launches``; a tensor the kernel does not take raises. On
    CPU tensors it runs :func:`fused_query_v2_reference`.
    """
    tensors = (*streams[:6], prefix)
    devices = {t.device for t in tensors}
    if devices == {CPU}:
        return fused_query_v2_reference(streams, prefix, n_docs=n_docs, membership=membership)
    C = prefix.shape[-1]
    lead, nt = check_launch("fused_query_v2", streams, tensors, devices, kernel_constants_v2(C))

    from memo_tpu_torch.ops._build import load_library

    lib = load_library()
    device = prefix.device
    n_win = lead[0] if lead else 1
    state = torch.zeros(n_win * nt + n_win, dtype=torch.int32, device=device)  # statuses, tickets
    sums = torch.empty((n_win, nt, 2, C), dtype=torch.int32, device=device)
    out = output_tensor(lead, streams.L, C, membership, device)
    with torch.cuda.device(device):
        err = lib.memo_fused_query_v2(
            *(t.data_ptr() for t in tensors), state.data_ptr(), sums.data_ptr(), out.data_ptr(),
            n_win, streams.pos_m.shape[-1], streams.pos_p.shape[-1], streams.L, C, streams.tile,
            n_docs, int(membership), torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise launch_error("fused_query_v2", lib, err)
    fused_query_v2.launches += 1
    return out


fused_query_v2.launches = 0
