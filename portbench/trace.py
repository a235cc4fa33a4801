"""What the traced stretch of a run shows, read from ``torch.profiler``.

The harness wraps each traced request in ``record_function(ANNOTATION)``.
From the profiler's events this keeps, on one timeline (microseconds):

- the device's operations (kernels, copies, memsets), and their union, the
  time the device was busy; copies count as busy;
- each traced request's span on the host, from issue until its host arrays
  were in hand;
- the host thread's other operations, to name what the host was doing while
  the device sat idle.

The traced window runs from the first traced request's issue to the last
one's return.
"""

from __future__ import annotations

import collections

import numpy as np

ANNOTATION = "portbench.request"
TOP = 10  # entries of each list of the breakdown
POINTS = 8  # points of an idle gap at which the host's operation is read


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def _union(spans: list[tuple[float, float]]) -> np.ndarray:
    """The union of [start, end) spans: float64[n, 2], sorted, disjoint."""
    merged: list[list[float]] = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return np.asarray(merged, np.float64).reshape(-1, 2)


class _Covered:
    """How much of [-inf, t) a union of spans covers, for any t."""

    def __init__(self, union: np.ndarray):
        self.starts, self.ends = union[:, 0], union[:, 1]
        self.before = np.concatenate([[0.0], np.cumsum(self.ends - self.starts)])

    def upto(self, t) -> np.ndarray:
        t = np.asarray(t, np.float64)
        if not self.starts.size:
            return np.zeros_like(t)
        i = np.searchsorted(self.starts, t, side="right") - 1
        inside = np.where(i >= 0, np.minimum(t, self.ends[i]) - self.starts[i], 0.0)
        return self.before[np.maximum(i, 0)] * (i >= 0) + inside

    def within(self, a, b) -> np.ndarray:
        return self.upto(b) - self.upto(a)


class Trace:
    def __init__(self, events):
        """``events``: ``profile.events()`` of the traced stretch."""
        self.device: list[tuple[float, float, str]] = []
        self.requests: list[tuple[float, float]] = []
        host = []
        for evt in events:
            span = (float(evt.time_range.start), float(evt.time_range.end))
            if str(evt.device_type).endswith("CUDA"):
                if not evt.name.startswith("portbench"):  # the annotation's device mirror
                    self.device.append((*span, evt.name))
            elif evt.name == ANNOTATION:
                self.requests.append(span)
                host.append((*span, evt.name, evt.thread))
            else:
                host.append((*span, evt.name, evt.thread))
        self.requests.sort()
        threads = {t for s, e, n, t in host if n == ANNOTATION}
        self.host = sorted(((s, e, n) for s, e, n, t in host if t in threads),
                           key=lambda h: (h[0], -h[1]))
        self.busy = _union([(s, e) for s, e, _ in self.device])
        self.kernels = _union([(s, e) for s, e, n in self.device if not _is_copy(n)])

    # ------------------------------------------------------------ totals, us
    @property
    def window(self) -> tuple[float, float]:
        return (self.requests[0][0], self.requests[-1][1]) if self.requests else (0.0, 0.0)

    def window_us(self) -> float:
        a, b = self.window
        return b - a

    def busy_us(self) -> float:
        return float(_Covered(self.busy).within(*self.window)) if self.requests else 0.0

    def kernel_us(self) -> float:
        return float(_Covered(self.kernels).within(*self.window)) if self.requests else 0.0

    def device_us(self, part: str) -> float:
        """Device time of the operations whose name holds ``part``, inside
        the window."""
        a, b = self.window
        return sum(min(e, b) - max(s, a) for s, e, n in self.device if part in n and e > a and s < b)

    def host_us(self) -> np.ndarray:
        """Each traced request's wall less the device's busy time inside it."""
        if not self.requests:
            return np.zeros(0)
        spans = np.asarray(self.requests, np.float64)
        walls = spans[:, 1] - spans[:, 0]
        return walls - _Covered(self.busy).within(spans[:, 0], spans[:, 1])

    def idle_pct(self) -> float | None:
        w = self.window_us()
        return 100.0 * (1.0 - self.busy_us() / w) if w > 0 and len(self.device) else None

    # ------------------------------------------------------------ breakdown
    def _gaps(self) -> list[tuple[float, float]]:
        a, b = self.window
        edges = [a, *self.busy[(self.busy[:, 1] > a) & (self.busy[:, 0] < b)].ravel(), b]
        gaps = [(max(s, a), min(e, b)) for s, e in zip(edges[::2], edges[1::2])]
        return [(s, e) for s, e in gaps if e > s]

    def _host_at(self, times) -> list[str]:
        """The innermost host operation running at each of ``times``
        (ascending); between requests, "between requests"."""
        stack, out, i = [], [], 0
        for t in times:
            while i < len(self.host) and self.host[i][0] <= t:
                while stack and stack[-1][1] <= self.host[i][0]:
                    stack.pop()
                stack.append(self.host[i])
                i += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            out.append(stack[-1][2] if stack else "between requests")
        return out

    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle time by
        what the host was doing, in seconds: at most TOP of each."""
        a, b = self.window
        ops = collections.Counter()
        for s, e, n in self.device:
            if e > a and s < b:
                ops[n] += (min(e, b) - max(s, a)) * 1e-6
        # each gap split over what the host ran at POINTS even points of it
        gaps = self._gaps()
        times = [s + (e - s) * (i + 0.5) / POINTS for s, e in gaps for i in range(POINTS)]
        widths = [float(e - s) / POINTS for s, e in gaps for _ in range(POINTS)]
        idle = collections.Counter()
        for width, name in zip(widths, self._host_at(times)):
            idle[name] += width * 1e-6
        return {"device_ops": [[n, v] for n, v in ops.most_common(TOP)],
                "idle_gaps": [[n, v] for n, v in idle.most_common(TOP)]}
