"""Dry run of the multi-device layer on tiny shapes, checked exactly.

    torchrun --nproc-per-node N -m memo_tpu_torch.parallel.dryrun [--device cpu]

Twin of memo_tpu's ``__graft_entry__.dryrun_multichip``: on a (2, N/2) mesh
(N even, else (1, N)) it runs ShardedQuery with both strategies,
membership, ResidentShardedQuery at k = 2, 3, 7 and a two-record placement
served by one dispatch, each against the port's numpy engine, and prints
one OK line with the mesh. ``--device cuda`` (the default) joins with NCCL,
``cpu`` with gloo. Without torchrun it runs the in-process 1 x 1 layout.
Any mismatch raises.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch.distributed as dist

from memo_tpu_torch.index.builder import store_from_ms
from memo_tpu_torch.parallel.distributed import initialize, launched, shutdown
from memo_tpu_torch.parallel.resident import ResidentShardedQuery
from memo_tpu_torch.parallel.sharded import Mesh, ShardedQuery, make_mesh
from memo_tpu_torch.query.engine import QueryEngine
from memo_tpu_torch.utils.device import resolve_device


def _equal(got, want, what: str) -> None:
    if not np.array_equal(np.asarray(got), want):
        raise RuntimeError(f"dryrun mismatch: {what}")


def dryrun_multichip(mesh: Mesh) -> str:
    """Runs every check on ``mesh`` (every rank of it must call this) and
    returns the OK line."""
    n = mesh.dp * mesh.sp
    rng = np.random.default_rng(42)
    n_docs, rec_len = 5, 16 * n
    ms = [rng.integers(0, 8, size=(rec_len, n_docs - 1)).astype(np.int32)]
    store = store_from_ms(ms, ["chrT"], [rec_len], n_docs, "conservation")
    windows = [("chrT", 0, rec_len), ("chrT", 3, rec_len // 2)]
    oracle = QueryEngine(store, backend="numpy", device="cpu")

    for strategy in ("position", "interval"):
        sq = ShardedQuery(store, mesh, strategy=strategy)
        for (rec, qs, qe), got in zip(windows, sq.conservation(windows, k=3)):
            _equal(got, oracle.conservation(rec, qs, qe, 3), f"{strategy} {rec}:{qs}-{qe}")
        memb = sq.membership(windows[:1], k=3)
        _equal(memb[0], oracle.membership("chrT", 0, rec_len, 3), f"{strategy} membership")

    rq = ResidentShardedQuery(store, mesh, k_max=32)
    for k in (2, 3, 7):
        _equal(rq.conservation(0, rec_len, k), oracle.conservation("chrT", 0, rec_len, k),
               f"resident k={k}")
    _equal(rq.conservation_windows([(3, rec_len // 2)], 3)[0],
           oracle.conservation("chrT", 3, rec_len // 2, 3), "resident window")

    # Distinct records ride the dp axis from one placement; one dispatch
    # per k serves both.
    ms2 = [
        rng.integers(0, 8, size=(rec_len, n_docs - 1)).astype(np.int32),
        rng.integers(0, 8, size=(rec_len // 2, n_docs - 1)).astype(np.int32),
    ]
    store2 = store_from_ms(ms2, ["chrA", "chrB"], [rec_len, rec_len // 2], n_docs, "conservation")
    oracle2 = QueryEngine(store2, backend="numpy", device="cpu")
    rq2 = ResidentShardedQuery(store2, mesh, records=["chrA", "chrB"], k_max=16)
    for name, ln in (("chrA", rec_len), ("chrB", rec_len // 2)):
        _equal(rq2.conservation(0, ln, 3, record=name), oracle2.conservation(name, 0, ln, 3),
               f"resident records= {name}")
    if rq2.dispatch_count != 1:
        raise RuntimeError(f"dryrun: {rq2.dispatch_count} dispatches for one k, want 1")
    return (f"dryrun_multichip OK: mesh={mesh.shape} device={mesh.device.type} "
            "strategies=position,interval,resident(+dp-records)")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m memo_tpu_torch.parallel.dryrun")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: one GPU per rank, NCCL; cpu: gloo [cuda]")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    created = launched() and initialize(device=device.type)
    try:
        n = dist.get_world_size() if dist.is_initialized() else 1
        dp = 2 if n % 2 == 0 and n > 1 else 1
        line = dryrun_multichip(make_mesh(dp, n // dp, device_type=device.type))
    except BaseException:
        if created:
            dist.destroy_process_group()
        raise
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(line, flush=True)
    if created:
        shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
