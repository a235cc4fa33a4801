"""Fused query, v2: one pass over the placed store's rows.

Counterpart of :mod:`memo_tpu.ops.pallas_query_v2`, the variant for dense
windows, with exactly the contract of v1's :func:`fused_query_rows`: the
placed store's six row tensors, the parameter block int32[Q, 5] and the
prefix int32[Q, C] in, conservation int32[Q, L] or
membership int8[Q, L, C] out, and the same plain version,
:func:`fused_query_rows_reference`. :func:`fused_query_v2_rows` runs the
hand-written CUDA kernel of ``csrc/fused_query_v2.cu``; its source note
says how it reads every row once and carries the coverage by a look-back.
"""

from __future__ import annotations

import torch

from memo_tpu_torch.ops.fused_query import (
    CPU,
    MAX_SMEM_BYTES,
    TILES,
    check_rows_launch,
    fused_query_rows_reference,
    launch_error,
    output_tensor,
)

STAGE_ROWS = 512  # rows of one stream in one ring stage (three int32 arrays)
STAGE_BYTES = 3 * 4 * STAGE_ROWS
MIN_STAGES, MAX_STAGES = 2, 8
RING_HEADER = MAX_STAGES * (2 * 8 + 8 * 4)  # the stages' barriers and metadata
SM_SMEM_BYTES = 233_472  # shared memory of one Hopper SM, for all its blocks
BLOCK_RESERVED = 1024  # shared memory the hardware keeps for each block
MAX_BLOCKS = 4  # blocks per SM that the ring is sized for
ROW_SLACK = 3  # rows past a window's last that a 16-byte bulk copy may read


def _smem_bytes(tile: int, stages: int, C: int) -> int:
    """Shared memory of one block: the ring header and ``stages`` stages,
    the tile int32[C][tile + 1], the carry and the aggregate [C], the first
    marked column of each position [tile], the epoch and the look-back's
    word."""
    return RING_HEADER + stages * STAGE_BYTES + (C * (tile + 1) + 2 * C + tile + 2) * 4


def v2_constants(C: int) -> tuple[int, int]:
    """(tile T, ring stages S) for ``C`` columns: the widest of 256/128/64
    that leaves room for at least two stages, and as many stages (up to 8)
    as fit without costing a block per SM (up to 4 planned)."""
    for tile in TILES:
        base = _smem_bytes(tile, 0, C)
        if base + MIN_STAGES * STAGE_BYTES > MAX_SMEM_BYTES:
            continue
        blocks = min(MAX_BLOCKS, SM_SMEM_BYTES // (base + MIN_STAGES * STAGE_BYTES + BLOCK_RESERVED))
        room = min(SM_SMEM_BYTES // blocks - BLOCK_RESERVED, MAX_SMEM_BYTES) - base
        return tile, min(MAX_STAGES, room // STAGE_BYTES)
    widest = (MAX_SMEM_BYTES - _smem_bytes(TILES[-1], MIN_STAGES, 0)) // ((TILES[-1] + 3) * 4)
    raise ValueError(f"fused query v2 supports at most {widest} columns, got C={C}")


# The kernel's state words (ticket, exit count, epoch, statuses), one set per
# device: zeroed once when allocated, left ready for the next launch by the
# kernel itself. Launches on one device therefore run one at a time (on one
# stream, or on streams that are ordered), as the engine runs them.
_STATE: dict[int, torch.Tensor] = {}


def _state(device: torch.device, n_words: int) -> torch.Tensor:
    state = _STATE.get(device.index)
    if state is None or state.numel() < n_words:
        state = _STATE[device.index] = torch.zeros(max(n_words, 1024), dtype=torch.int32,
                                                   device=device)
    return state


def fused_query_v2_rows(placed, params: torch.Tensor, prefix: torch.Tensor, *, k: int, L: int,
                        C: int, n_docs: int, membership: bool):
    """Conservation int32[Q, L] or membership int8[Q, L, C] of Q windows of
    L positions at k, from the placed store (``engine.PlacedStore``, six
    int32 row tensors, each with at least 3 rows after the last one a window
    names, as ``place_store`` leaves them), the parameter block ``params``
    int32[Q, 5] and the prefix int32[Q, C].

    On CUDA tensors this launches the kernel of ``csrc/fused_query_v2.cu`` on
    the current stream, once for the whole batch, and counts the launch in
    ``fused_query_v2_rows.launches``; a tensor the kernel does not take
    raises. On CPU tensors it runs :func:`fused_query_rows_reference`.
    """
    tensors = (*placed, params, prefix)
    devices = {t.device for t in tensors}
    if devices == {CPU}:
        return fused_query_rows_reference(placed, params, prefix, k=k, L=L, C=C, n_docs=n_docs,
                                          membership=membership)
    n_win, n_rows = check_rows_launch("fused_query_v2_rows", placed, params, prefix, devices, k=k,
                                      L=L, C=C)
    tile, stages = v2_constants(C)
    if n_rows <= ROW_SLACK or any(t.data_ptr() % 16 for t in placed):
        raise ValueError("fused_query_v2_rows reads the store rows in 16-byte copies: each row "
                         f"tensor must be 16-byte aligned and hold more than {ROW_SLACK} rows")

    from memo_tpu_torch.ops._build import load_library

    lib = load_library()
    device = params.device
    units = n_win * -(-L // tile)
    state = _state(device, 4 + units)
    sums = torch.empty(units * 2 * C, dtype=torch.int32, device=device)
    out = output_tensor((n_win,), L, C, membership, device)
    with torch.cuda.device(device):  # the launch goes to the current device
        err = lib.memo_fused_query_v2_rows(
            *(t.data_ptr() for t in tensors), state.data_ptr(), sums.data_ptr(), out.data_ptr(),
            n_rows - ROW_SLACK, n_win, L, C, k, tile, stages, n_docs, int(membership),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise launch_error("fused_query_v2_rows", lib, err)
    fused_query_v2_rows.launches += 1
    return out


fused_query_v2_rows.launches = 0
