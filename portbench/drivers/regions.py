"""Regions files: one client sends ``QueryEngine.conservation_batch``
requests in a closed loop, each a batch of windows of the record sorted by
start, as the CLI's ``--regions-file`` hands them over, and waits for the
host arrays.

Traffic parameters (``traffic/<mix>.json``): ``windows`` (per batch),
``length_median`` and ``length_mean`` (window lengths, log-normal with that
median and mean), ``k``. Every batch holds the same lengths, at the
distribution's evenly spaced quantiles; the seed draws each window's start
(uniform over the record) and which length it gets, so every seed and batch
asks for the same work at other places.
"""

from __future__ import annotations

import math
import statistics
from typing import NamedTuple

import numpy as np


class Request(NamedTuple):
    windows: list  # [(qs, qe)], sorted by qs
    k: int


def _lengths(traffic: dict) -> np.ndarray:
    n, median, mean = int(traffic["windows"]), traffic["length_median"], traffic["length_mean"]
    sigma = math.sqrt(2.0 * math.log(mean / median))  # a log-normal's mean / median = e^(sigma^2 / 2)
    z = np.array([statistics.NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    return np.maximum(np.rint(median * np.exp(sigma * z)), 1).astype(np.int64)


def _batches(traffic: dict, record_len: int, rng):
    lengths, k = _lengths(traffic), int(traffic["k"])
    if lengths.max() > record_len:
        raise ValueError("windows longer than the record")
    while True:
        lens = rng.permutation(lengths)
        starts = rng.integers(0, record_len - lens + 1)
        by_start = np.argsort(starts, kind="stable")
        qs, qe = starts[by_start], starts[by_start] + lens[by_start]
        yield Request(list(zip(qs.tolist(), qe.tolist())), k)


def stream(traffic: dict, record_len: int, seed):
    """The endless sequence of batches of ``seed`` (any seed of
    ``numpy.random.default_rng``)."""
    return _batches(traffic, record_len, np.random.default_rng(seed))


def warmup(traffic: dict, record_len: int, seed: int) -> list[Request]:
    """A batch of the mix's one shape (every batch pads to the same longest
    window), from another stream of the seed."""
    return [next(_batches(traffic, record_len, np.random.default_rng([seed, 1])))]


def issue(engine, record: str, req: Request) -> list:
    """The batch through the program: one host array per window."""
    return engine.conservation_batch(record, req.windows, req.k)
