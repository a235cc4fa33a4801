"""Single windows: one client sends ``QueryEngine.conservation`` requests in
a closed loop, each for one window of the record at one k, and waits for the
host array.

Traffic parameters (``traffic/<mix>.json``): ``length_min`` and
``length_max`` (window lengths, uniform), ``k_per_block`` ([k, count]
pairs), ``block`` (requests per block; the counts sum to it). Every block
holds the same lengths, at the block's evenly spaced quantiles, and the same
ks; the seed shuffles both and draws the starts (uniform over the record),
so every seed asks for the same work in another order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

DRAW = 1024  # requests drawn at once, so the window spends little on drawing them


class Request(NamedTuple):
    windows: list  # [(qs, qe)]
    k: int


def _lengths(traffic: dict) -> np.ndarray:
    n, lo, hi = int(traffic["block"]), int(traffic["length_min"]), int(traffic["length_max"])
    return np.rint(lo + (hi - lo) * (np.arange(n) + 0.5) / n).astype(np.int64)


def _ks(traffic: dict) -> np.ndarray:
    ks = np.concatenate([np.full(int(c), int(k)) for k, c in traffic["k_per_block"]])
    if ks.size != int(traffic["block"]):
        raise ValueError("k_per_block counts must sum to block")
    return ks


def stream(traffic: dict, record_len: int, seed):
    """The endless sequence of requests of ``seed`` (any seed of
    ``numpy.random.default_rng``), drawn ``DRAW`` requests at a time."""
    rng = np.random.default_rng(seed)
    lengths, ks = _lengths(traffic), _ks(traffic)
    if lengths.max() > record_len:
        raise ValueError("windows longer than the record")
    blocks = max(1, DRAW // lengths.size)
    while True:
        lens = rng.permuted(np.tile(lengths, (blocks, 1)), axis=1).ravel()
        kk = rng.permuted(np.tile(ks, (blocks, 1)), axis=1).ravel()
        starts = rng.integers(0, record_len - lens + 1)
        for qs, n, k in zip(starts.tolist(), lens.tolist(), kk.tolist()):
            yield Request([(qs, qs + n)], k)


def warmup(traffic: dict, record_len: int, seed: int) -> list[Request]:
    """The longest window at each k of the mix, at the record's two ends."""
    n = int(traffic["length_max"])
    return [Request([(qs, qs + n)], int(k)) for k, _ in traffic["k_per_block"]
            for qs in (0, record_len - n)]


def issue(engine, record: str, req: Request) -> list:
    """The request through the program: one host array per window."""
    (qs, qe), = req.windows
    return [engine.conservation(record, qs, qe, req.k)]
