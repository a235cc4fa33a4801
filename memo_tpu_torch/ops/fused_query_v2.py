"""Fused query, v2: one pass over the placed store's rows.

Counterpart of :mod:`memo_tpu.ops.pallas_query_v2`, the variant for dense
windows, with exactly the contract of v1's :func:`fused_query_rows`: the
placed store's six row tensors, the parameter block int32[Q, 5] and the
prefix int32[Q, C] in, conservation int32[Q, L] or
membership int8[Q, L, C] out (a ragged batch's :class:`Offsets` give the
packed output), and the same plain version,
:func:`fused_query_rows_reference`. :func:`fused_query_v2_rows` runs the
hand-written CUDA kernel of ``csrc/fused_query_v2.cu``; its source note
says how it reads every row once and carries the coverage by a look-back.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from memo_tpu_torch.ops._build import launch, load_library
from memo_tpu_torch.ops.fused_query import (
    MAX_SMEM_BYTES,
    TILES,
    Offsets,
    check_rows_launch,
    launch_error,
    launch_groups,
    plain_group,
    ragged_units,
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


# Columns of one v2 launch: the widest C that v2_constants takes (819).
MAX_COLUMNS = (MAX_SMEM_BYTES - _smem_bytes(TILES[-1], MIN_STAGES, 0)) // ((TILES[-1] + 3) * 4)


@functools.lru_cache(maxsize=None)
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
    raise ValueError(f"fused query v2 supports at most {MAX_COLUMNS} columns, got C={C}")


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


def _launch_group(placed, params, prefix, out, n_rows, *, k: int, L: int, C: int, c0: int, G: int,
                  n_docs: int, membership: bool, offsets: Offsets | None = None) -> None:
    """One launch of the kernel of ``csrc/fused_query_v2.cu`` over
    ``params``' windows and the column group [c0, c0 + G) into ``out``
    (:func:`~memo_tpu_torch.ops.fused_query.launch_groups`), counted in
    ``fused_query_v2_rows.launches``; its plain version where ``n_rows`` is
    None (CPU tensors). Its state and sums hold a word and 2 G words per
    run, sized for runs of one tile (the kernel picks longer ones)."""
    if n_rows is None:
        return plain_group(placed, params, prefix, out, k=k, L=L, C=C, c0=c0, G=G,
                           n_docs=n_docs, membership=membership, offsets=offsets)
    n_win = params.shape[0]
    tile, stages = v2_constants(G)
    lib = load_library()
    device = params.device
    if offsets is None:
        units, table, total, tiles = n_win * -(-L // tile), None, 0, 0
    else:
        total, table = offsets.total, offsets.device.data_ptr()
        units = ragged_units(total, n_win, tile)
        tiles = int((-(-np.diff(offsets.host) // tile)).sum())
    state = _state(device, 4 + units)
    sums = torch.empty(units * 2 * G, dtype=torch.int32, device=device)
    err = launch(lib.memo_fused_query_v2_rows, device,
                 *(t.data_ptr() for t in (*placed, params, prefix)), state.data_ptr(),
                 sums.data_ptr(), out.data_ptr(), table, total, tiles, n_rows - ROW_SLACK, n_win, L,
                 C, c0, G, k, tile, stages, n_docs, int(membership))
    if err != 0:
        raise launch_error("fused_query_v2_rows", lib, err)
    fused_query_v2_rows.launches += 1


def fused_query_v2_rows(placed, params: torch.Tensor, prefix: torch.Tensor, *, k: int, L: int,
                        C: int, n_docs: int, membership: bool, offsets: Offsets | None = None):
    """Conservation int32[Q, L] or membership int8[Q, L, C] of Q windows of
    L positions at k, from the placed store (``engine.PlacedStore``, six
    int32 row tensors, each with at least 3 rows after the last one a window
    names, as ``place_store`` leaves them), the parameter block ``params``
    int32[Q, 5] and the prefix int32[Q, C], for any Q and any C; with a
    ragged batch's ``offsets``, the packed output of each window's own
    length, as :func:`~memo_tpu_torch.ops.fused_query.fused_query_rows`.

    On CUDA tensors this launches the kernel of ``csrc/fused_query_v2.cu`` on
    the current stream, once where the call fits one launch, else once per
    window and column group (:func:`~memo_tpu_torch.ops.fused_query.launch_groups`),
    and counts each launch in ``fused_query_v2_rows.launches``; a tensor the
    kernel does not take raises. On CPU tensors each group runs the plain
    version, :func:`~memo_tpu_torch.ops.fused_query.fused_query_rows_reference`.
    """
    n_rows = check_rows_launch("fused_query_v2_rows", placed, params, prefix, k=k, L=L, C=C,
                               offsets=offsets)
    if n_rows is not None and (n_rows <= ROW_SLACK or any(t.data_ptr() % 16 for t in placed)):
        raise ValueError("fused_query_v2_rows reads the store rows in 16-byte copies: each row "
                         f"tensor must be 16-byte aligned and hold more than {ROW_SLACK} rows")
    return launch_groups(_launch_group, placed, params, prefix, n_rows, widest=MAX_COLUMNS, k=k,
                         L=L, C=C, n_docs=n_docs, membership=membership, offsets=offsets)


fused_query_v2_rows.launches = 0
