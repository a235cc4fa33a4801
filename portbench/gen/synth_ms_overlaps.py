"""A conservation index's interval columns, made on the device from a seed.

A frozen copy of the repository's synthetic pangenome recipe and of the
overlap extraction that turns matching statistics (MS) into an index's rows,
written as plain torch operations so that a whole chromosome is made on the
card in seconds rather than on the host in tens of them:

- the recipe (``chip_smoke.synth_ms``, streamed as
  ``chip_smoke.build_chromosome_store`` streams it): each of the ``n_docs - 1``
  genome columns gets ``length // gap`` distinct match anchors at uniform
  positions, each with a match length uniform in [match_min, match_max); a
  position's MS is the least ``anchor position + match length`` over the
  anchors at or right of it, less the position, capped at the record's end;
- the extraction (``memo_tpu_torch/native/libms.cpp``'s ``ms_overlaps_chunk``,
  the reference's dap_to_bed.py with ``--mem --order --overlap``): each
  position's MS row sorted descending ("order MEMs"), a MEM ``[p, p + ms)``
  wherever a column's MS does not fall by one from the previous position, and
  per column the overlap ``[p, min(previous MEM end, p + ms))`` of each MEM
  with the one before it, bookends kept; then the end-of-record sentinel row.
  Rows come out in the program's order: by position, then by column.

The anchors are drawn with a ``torch.Generator`` on ``device``: per column,
more positions than needed with replacement, of which the first ``length //
gap`` distinct ones in draw order are kept (a uniform sample without
replacement). Nothing of the program is imported; a test holds the columns
equal to the program's own ``store_from_ms`` of the same anchors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

CHUNK_ROWS = 1 << 22  # positions whose MS rows are made and extracted at a time
_FAR = 1 << 30  # above every anchor's end: "no anchor to the right"


class Inputs(NamedTuple):
    """One record's interval columns on the host, sorted by start, and what
    the index stores beside them."""

    record: str
    length: int
    n_docs: int
    start: np.ndarray  # int64[M]
    end: np.ndarray  # int64[M]
    order: np.ndarray  # int32[M], 1-based column of the sorted MS row
    longest: int  # the longest end - start


def _generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    return g


def anchors(config: dict, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Each genome column's anchors on ``device``: positions int64[D, n],
    ascending, distinct, and their match lengths int64[D, n]."""
    device = torch.device(device)
    length, n_cols = int(config["record_len"]), int(config["n_docs"]) - 1
    n = max(length // int(config["gap"]), 1)
    if n > length:
        raise ValueError(f"{n} anchors do not fit {length} positions")
    # Draws beyond n cover the expected repeats (n^2 / 2L) many times over.
    m = min(n + 2 * n * n // length + 6 * int(n ** 0.5) + 64, 1 << 31)
    g = _generator(seed, device)
    draw = torch.randint(0, length, (n_cols, m), generator=g, device=device)
    value = torch.randint(int(config["match_min"]), int(config["match_max"]), (n_cols, m),
                          generator=g, device=device)
    ranked, where = torch.sort(draw, dim=1, stable=True)
    first = torch.ones_like(ranked, dtype=torch.bool)
    first[:, 1:] = ranked[:, 1:] != ranked[:, :-1]
    keep = torch.zeros_like(first).scatter_(1, where, first)  # first draws of each position
    keep &= keep.cumsum(1) <= n
    if int(keep.sum(1).min()) < n:
        raise RuntimeError("too few distinct anchor draws; draw more")
    pos, value = draw[keep].view(n_cols, n), value[keep].view(n_cols, n)
    by_pos = pos.argsort(dim=1)
    return pos.gather(1, by_pos), value.gather(1, by_pos)


class _Carry(NamedTuple):
    row: torch.Tensor | None  # int32[D]: the previous position's sorted MS row
    end: torch.Tensor  # int32[D]: each column's last MEM end, -1 before any


def _ms_rows(pos: torch.Tensor, reach: torch.Tensor, lo: int, hi: int, length: int) -> torch.Tensor:
    """MS of positions [lo, hi), each position's row sorted descending, as
    int32[D, hi - lo] (a column of the sorted rows per row of the tensor)."""
    p = torch.arange(lo, hi, dtype=torch.int32, device=pos.device)
    nxt = torch.searchsorted(pos, p.expand(pos.shape[0], -1).contiguous(), out_int32=True)
    ms = torch.minimum(reach.gather(1, nxt.long()) - p, length - p)
    return ms.t().sort(dim=1, descending=True).values.t().contiguous()


def _extract(ms: torch.Tensor, lo: int, carry: _Carry):
    """The overlap rows of the sorted MS ``ms`` (int32[D, P]) of positions
    [lo, lo + P): (start, end, order) int32 on the device in
    position-then-column order, and the carry into the next positions. A
    column's MEMs are found in column order, so each one's predecessor is
    the entry before it; the rows are then sorted by (position, column)."""
    D, P = ms.shape
    emit = torch.empty_like(ms, dtype=torch.bool)
    if carry.row is None:
        emit[:, 0] = True  # a record's first position starts a MEM in every column
    else:
        emit[:, 0] = carry.row <= ms[:, 0]
    emit[:, 1:] = ms[:, :-1] <= ms[:, 1:]
    col, at = torch.nonzero(emit, as_tuple=True)  # by column, then position
    del emit
    pos = at.to(torch.int32) + lo
    mem_end = pos + ms[col, at]
    first = torch.ones_like(col, dtype=torch.bool)
    first[1:] = col[1:] != col[:-1]
    prev_end = torch.empty_like(mem_end)
    prev_end[1:] = mem_end[:-1]
    prev_end = torch.where(first, carry.end[col], prev_end)
    last = torch.ones_like(first)
    last[:-1] = first[1:]
    end = carry.end.clone()
    end[col[last]] = mem_end[last]
    ov_end = torch.minimum(prev_end, mem_end)
    keep = ov_end >= pos
    col, pos, ov_end = col[keep], pos[keep], ov_end[keep]
    by_pos = torch.argsort(pos.to(torch.int64) * D + col)
    out = (pos[by_pos], ov_end[by_pos], col[by_pos].to(torch.int32) + 1)
    return out, _Carry(ms[:, -1].clone(), end)


def columns_of_anchors(pos: torch.Tensor, value: torch.Tensor, length: int,
                       chunk: int = CHUNK_ROWS) -> tuple[torch.Tensor, ...]:
    """The record's overlap rows from its anchors, on their device: start,
    end and order, int32, in the program's row order."""
    far = torch.full_like(pos[:, :1], _FAR)
    reach = torch.cat([pos + value, far], 1).flip(1).cummin(1).values.flip(1)
    reach, pos = reach.to(torch.int32).contiguous(), pos.to(torch.int32).contiguous()
    D = pos.shape[0]
    carry = _Carry(None, torch.full((D,), -1, dtype=torch.int32, device=pos.device))
    parts = []
    for lo in range(0, length, chunk):
        out, carry = _extract(_ms_rows(pos, reach, lo, min(lo + chunk, length), length), lo, carry)
        parts.append(out)
    if length:  # the sentinel row (pos = L, ms = L): every column with a MEM emits
        ov_end = torch.minimum(carry.end, torch.tensor(2 * length, dtype=torch.int32,
                                                        device=pos.device))
        c = torch.nonzero((carry.end >= 0) & (ov_end >= length), as_tuple=True)[0]
        parts.append((torch.full_like(c, length, dtype=torch.int32), ov_end[c],
                      c.to(torch.int32) + 1))
    return tuple(torch.cat(col) for col in zip(*parts))


def generate(config: dict, seed: int, device) -> Inputs:
    """The configuration's record, made on ``device`` from ``seed``, as host
    columns."""
    length = int(config["record_len"])
    pos, value = anchors(config, seed, device)
    start, end, order = columns_of_anchors(pos, value, length)
    del pos, value
    longest = int((end - start).max()) if start.numel() else 0
    return Inputs(config["record"], length, int(config["n_docs"]),
                  start.to(torch.int64).cpu().numpy(), end.to(torch.int64).cpu().numpy(),
                  order.cpu().numpy(), longest)
