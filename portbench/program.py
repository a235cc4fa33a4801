"""What the program records of itself in a ``--trace 1`` run, for the
readers of its per-layer metrics: its spans, CPU operations on the
profiler's timeline (``Trace.host``), and its counters
(``memo_tpu_torch.utils.profiling.counters()``), which count only while a
profiler records, so after the window they hold the traced requests' work.
A program that records neither gives each reader nothing to read."""

from __future__ import annotations

import numpy as np

from portbench.trace import _Covered, _union


def spans(trace, *names: str) -> np.ndarray:
    """The union of the host spans named ``names`` inside the traced window,
    each clipped to it: float64[n, 2], us, sorted and disjoint, so that a
    span inside another counts once."""
    a, b = trace.window
    return _union([(max(s, a), min(e, b)) for s, e, n in trace.host
                   if n in names and e > a and s < b])


def span_us(spans: np.ndarray) -> float:
    return float((spans[:, 1] - spans[:, 0]).sum())


def kernel_us_within(trace, spans: np.ndarray) -> float:
    """The time inside ``spans`` in which a kernel ran on the device
    (copies and memsets left out)."""
    return float(_Covered(trace.kernels).within(spans[:, 0], spans[:, 1]).sum())


def counter(name: str) -> int | None:
    """The program's counter ``name``; None where it has no counters or
    counted nothing under that name."""
    try:
        from memo_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    return counters().get(name)


def per(counted: int | None, base: int) -> float | None:
    """``counted / base``, or None where either is missing."""
    return None if counted is None or not base else counted / base
