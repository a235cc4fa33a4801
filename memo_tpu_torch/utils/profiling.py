"""``--profile DIR``: a torch.profiler trace of the wrapped region."""

from __future__ import annotations

import contextlib
import os

import torch


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
