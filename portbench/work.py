"""The least work a conservation query needs, counted from the inputs, and
the least time the card could take for it.

A window [qs, qe) at k needs every interval that marks one of its positions,
and no other: those with ``qs < start``, ``end <= qe + k - 2`` and ``end -
start <= k - 2`` (see ``reference/conservation.py``). Each is read once, as
three int32 (start, end, order: 12 bytes), and each position's int32 output
is written once. The count does not depend on how the program finds or
stores its rows. Among the rows with ``end - start <= k - 2``, those with
``start <= qs`` all end by ``qs + k - 2``, so the count is ``#{end <= qe + k
- 2} - #{start <= qs}`` over those rows: two binary searches a window.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

ROW_BYTES = 12
OUT_BYTES = 4
PEAKS = pathlib.Path(__file__).resolve().parent / "peaks.json"


def marking_rows(start: np.ndarray, end: np.ndarray, windows, device) -> np.ndarray:
    """int64[W]: the rows that mark each window (qs, qe, k) of ``windows``,
    counted on ``device``."""
    windows = np.asarray(windows, np.int64).reshape(-1, 3)
    out = np.zeros(len(windows), np.int64)
    if not len(windows):
        return out
    s = torch.from_numpy(start).to(device)
    e = torch.from_numpy(end).to(device)
    for k in np.unique(windows[:, 2]):
        at = np.flatnonzero(windows[:, 2] == k)
        short = (e - s) <= int(k) - 2
        starts = s[short]
        ends = e[short].sort().values
        del short
        qs = torch.from_numpy(windows[at, 0]).to(device)
        last = torch.from_numpy(windows[at, 1] + int(k) - 2).to(device)
        got = (torch.searchsorted(ends, last, right=True)
               - torch.searchsorted(starts, qs, right=True))
        out[at] = got.cpu().numpy()
        del starts, ends
    return out


def memory_bytes_per_s(kind: str) -> float | None:
    """The device's peak memory rate from ``peaks.json``; None for a device
    the table does not hold."""
    peaks = json.loads(PEAKS.read_text())
    entry = peaks.get(kind)
    return None if entry is None else float(entry["memory_bytes_per_s"])


def least_seconds(rows: int, positions: int, kind: str) -> float | None:
    """The least time ``kind`` could take to read ``rows`` and write
    ``positions`` outputs."""
    rate = memory_bytes_per_s(kind)
    return None if rate is None else (rows * ROW_BYTES + positions * OUT_BYTES) / rate
