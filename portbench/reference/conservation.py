"""Conservation of a window, in plain PyTorch, from an index's interval columns.

The reference pipeline's query (memo_query.py:42-71, the MEMO repository):
each interval of the window is recentred, its end shadow-cast back by
``k - 1`` and both clipped to the window; an interval whose cast end lies
below its start marks the positions [cast end, start) in the column of its
``order``; a position's conservation is the least marked order, or
``n_docs`` where none marks (``argmax`` over the marks with a last column of
ones). Only intervals with ``qs < start < qe + k - 1`` can mark (a start at
or before ``qs`` clips to 0; one past that cannot be cast into the window),
and the columns are sorted by start, so those rows are one slice found by
binary search here. The marks are counted per (order, position) with a
difference array, a block of positions at a time; a position's least order
with a count above 0 is its answer.

Plain torch operations on any device: in a run, on the card once the
program's state is freed (the columns go up once); in the tests, on the
CPU. It imports nothing of the program, and takes nothing the program made:
only the columns the benchmark generated.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK = 1 << 22  # positions whose (order, position) counts are held at once


class Reference:
    def __init__(self, inputs, device):
        """``inputs``: a generator's ``Inputs``; its columns go to ``device``."""
        self.n_docs = int(inputs.n_docs)
        self.start, self.end, self.order = (torch.from_numpy(np.asarray(a)).to(device)
                                            for a in (inputs.start, inputs.end, inputs.order))

    def _cut(self, v: int) -> int:
        """The first row whose start is not below ``v``."""
        return int(torch.searchsorted(self.start, torch.tensor([v], device=self.start.device)))

    def answer(self, qs: int, qe: int, k: int) -> np.ndarray:
        """int32[qe - qs]: the conservation of window [qs, qe) at ``k``."""
        return self._rows(self._cut(qs + 1), self._cut(qe + k - 1), qs, qe, k)

    def control(self, qs: int, qe: int, k: int) -> np.ndarray:
        """The control: :meth:`answer` with the window's rows cut at its
        end, so the intervals that start in the ``k - 1`` positions past it
        and mark back into it are lost. A shortcut a faster window search
        would be tempted by; it breaks the exactness the configurations
        state."""
        return self._rows(self._cut(qs + 1), self._cut(qe), qs, qe, k)

    def _rows(self, lo: int, hi: int, qs: int, qe: int, k: int) -> np.ndarray:
        """The conservation of window [qs, qe) at ``k`` over rows [lo, hi)."""
        L, n = qe - qs, self.n_docs
        dev = self.start.device
        s = (self.start[lo:hi] - qs).clamp(0, L)
        ce = (self.end[lo:hi] - qs - (k - 1)).clamp(0, L)
        keep = ce < s
        s, ce, o = s[keep], ce[keep], self.order[lo:hi][keep].to(torch.int64)
        out = torch.empty(L, dtype=torch.int32, device=dev)
        orders = torch.arange(n + 1, dtype=torch.int32, device=dev)[:, None]
        for b0 in range(0, L, BLOCK):
            b1 = min(b0 + BLOCK, L)
            width = b1 - b0 + 1
            # rows whose marks reach into [b0, b1): s > b0 and ce < b1
            sel = (s > b0) & (ce < b1)
            bs, bce, bo = s[sel].clamp(max=b1) - b0, ce[sel].clamp(min=b0) - b0, o[sel]
            diff = torch.zeros((n + 1) * width, dtype=torch.int32, device=dev)
            one = torch.ones_like(bo, dtype=torch.int32)
            diff.index_add_(0, bo * width + bce, one)
            diff.index_add_(0, bo * width + bs, -one)
            marked = diff.view(n + 1, width)[:, :-1].cumsum(1, dtype=torch.int32) > 0
            marked[n] = True
            out[b0:b1] = torch.where(marked, orders, n + 1).amin(0)
        return out.cpu().numpy()
