"""Stage timers and ``--profile DIR``.

``stage_timer`` wraps pipeline stages with wall-clock accounting (the port's
copy of :mod:`memo_tpu.utils.profiling`'s timers); ``trace_context`` writes a
torch.profiler trace of the wrapped region.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch

from memo_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


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
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        (times or GLOBAL_TIMES).add(name, dt)
        if log_it:
            log.debug("stage %s: %.3fs", name, dt)


@contextlib.contextmanager
def trace_context(trace_dir: str | None):
    """Write a Chrome trace (``DIR/trace.json``, viewable in Perfetto or
    chrome://tracing) of the wrapped region when trace_dir is set; no-op
    otherwise. The trace holds CUDA kernels when a GPU is present."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
