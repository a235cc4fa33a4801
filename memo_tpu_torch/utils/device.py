"""Device selection: the caller names the device, and nothing swaps it."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for an explicit "cuda" or "cpu" (or a torch.device).
    Raises when "cuda" is asked for and no CUDA device is available."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device is available")
    return dev
