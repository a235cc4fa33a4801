"""Single-device compile check: one conservation window on tiny shapes.

    python -m memo_tpu_torch.entry [--device cpu]

Twin of memo_tpu's ``__graft_entry__.entry()``: the same L=1024, C=8,
M=256 window from seed 0 through the port's
:func:`~memo_tpu_torch.ops.query_ops.conservation_window`, with the
arguments as tensors on ``device``. Prints the output's shape and dtype.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from memo_tpu_torch.ops.query_ops import conservation_window
from memo_tpu_torch.utils.device import resolve_device


def entry(device="cuda"):
    """``(fn, example_args)``: ``fn(*example_args)`` is int32[1024], the
    conservation of one window at qs=0, k=31."""
    dev = resolve_device(device)
    L, C, M = 1024, 8, 256
    rng = np.random.default_rng(0)
    starts = rng.integers(0, 900, M).astype(np.int32)
    ends = starts + rng.integers(0, 50, M).astype(np.int32)
    orders = rng.integers(1, C, M).astype(np.int32)

    def fn(starts, ends, orders, qs, k):
        return conservation_window(starts, ends, orders, qs, k, L=L, C=C, n_docs=C)

    example_args = tuple(torch.as_tensor(a, device=dev) for a in (starts, ends, orders)) + (
        torch.tensor(0, dtype=torch.int32, device=dev),
        torch.tensor(31, dtype=torch.int32, device=dev),
    )
    return fn, example_args


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m memo_tpu_torch.entry", description=__doc__)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    fn, example_args = entry(args.device)
    out = fn(*example_args)
    print("entry OK:", tuple(out.shape), out.dtype)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
