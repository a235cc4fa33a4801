"""Stage timers, spans and counters, and ``--profile DIR``.

``stage_timer`` wraps pipeline stages with wall-clock accounting (the port's
copy of :mod:`memo_tpu.utils.profiling`'s timers); ``trace_context`` writes a
torch.profiler trace of the wrapped region.

Tracing is on exactly while a torch profiler records in this process. Then
``span(name)`` records a CPU operation on the profiler's timeline, beside
the device's activities (never a user annotation, which the profiler would
mirror on the device), and ``count(name, n)`` adds to a process-wide
counter; a stage timer also opens its stage's span. While tracing is off
each costs one flag check. ``counters()`` reads the counters and
``reset_counters()`` clears them, so the counts read after a traced stretch
are those of the work issued inside it.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from dataclasses import dataclass, field

import torch
import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

from memo_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

_OFF = contextlib.nullcontext()
_LOCK = threading.Lock()
_TOTALS: dict[str, int] = {}
_PENDING: list[tuple[str, torch.Tensor]] = []  # counts left on the device, summed when read


def span(name: str):
    """A context manager that, while tracing is on, records the CPU
    operation ``name`` around its block; its parent is the span enclosing
    it on the thread."""
    return _RecordFunctionFast(name) if _profiler._is_profiler_enabled else _OFF


def tracing() -> bool:
    """Whether tracing is on: a torch profiler records in this process."""
    return _profiler._is_profiler_enabled


def count(name: str, n) -> None:
    """Adds ``n`` to the counter ``name`` while tracing is on. ``n`` is an
    int, or an integer tensor whose sum counts: it is kept, unread, and
    summed when :func:`counters` is read."""
    if not _profiler._is_profiler_enabled:
        return
    with _LOCK:
        if isinstance(n, torch.Tensor):
            _PENDING.append((name, n))
        else:
            _TOTALS[name] = _TOTALS.get(name, 0) + int(n)


def counters() -> dict[str, int]:
    """A snapshot of the counters since the last :func:`reset_counters`;
    counts kept on a device are read here, once its work is done."""
    with _LOCK:
        for device in {t.device for _, t in _PENDING if t.device.type == "cuda"}:
            torch.cuda.synchronize(device)
        while _PENDING:
            name, t = _PENDING.pop()
            _TOTALS[name] = _TOTALS.get(name, 0) + int(t.sum())
        return dict(_TOTALS)


def reset_counters() -> None:
    with _LOCK:
        _TOTALS.clear()
        _PENDING.clear()


@dataclass
class StageTimes:
    times: dict[str, float] = field(default_factory=dict)

    def add(self, name: str, seconds: float) -> None:
        self.times[name] = self.times.get(name, 0.0) + seconds

    def report(self) -> str:
        return ", ".join(f"{k}={v:.3f}s" for k, v in self.times.items())


GLOBAL_TIMES = StageTimes()


@contextlib.contextmanager
def stage_timer(name: str, times: StageTimes | None = None, log_it: bool = True):
    """The block's seconds added to ``times`` (else ``GLOBAL_TIMES``) under
    ``name``; while tracing is on, the block is also the span ``name``."""
    t0 = time.perf_counter()
    try:
        with span(name):
            yield
    finally:
        dt = time.perf_counter() - t0
        (times or GLOBAL_TIMES).add(name, dt)
        if log_it:
            log.debug("stage %s: %.3fs", name, dt)


@contextlib.contextmanager
def trace_context(trace_dir: str | None):
    """Write a Chrome trace (``DIR/trace.json``, viewable in Perfetto or
    chrome://tracing) of the wrapped region, and beside it the counters of
    the work issued in it (``DIR/counters.json``), when trace_dir is set;
    no-op otherwise. The trace holds CUDA kernels when a GPU is present."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    reset_counters()
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    with open(os.path.join(trace_dir, "counters.json"), "w") as fh:
        json.dump(counters(), fh, indent=1, sort_keys=True)
