"""memo-tpu-torch CLI: ``python -m memo_tpu_torch {index, query, view, extract}``.

``index``, ``view`` and ``extract`` are memo_tpu's own commands (host only).
``query`` (``-r`` or ``--regions-file``) takes memo_tpu's flags and runs on
this package's engine, with ``--device {cuda,cpu}`` (default cuda; no GPU is
an error) and ``--backend {auto,fused,torch,numpy}``. Outputs are
byte-identical to ``python -m memo_tpu query``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from memo_tpu import cli as ref_cli
from memo_tpu.utils.logging import get_logger
from memo_tpu_torch.utils.profiling import trace_context

log = get_logger(f"memo_tpu.{__name__}")


def _add_query(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser("query", help="query k-mer membership or conservation on pivot genome region")
    p.add_argument(
        "-b", dest="index", required=True, help="MEMO index (.npz native, .parquet or .bed compat)"
    )
    p.add_argument("-k", dest="k", type=int, default=31, help="k-mer size [31]")
    p.add_argument(
        "-n",
        dest="num_docs",
        type=int,
        default=None,
        help="total number of documents in pangenome (incl. pivot); "
        "required for .parquet/.bed, stored in .npz",
    )
    p.add_argument(
        "-r",
        dest="region",
        default=None,
        help="query region (0-indexed, half open '[)' coordinates) chr:start-end",
    )
    p.add_argument(
        "--regions-file",
        default=None,
        help="batch mode: file with one region per line; outputs are written "
        "to <out>.<chr>_<start>_<end>.txt",
    )
    p.add_argument(
        "--mesh",
        default=None,
        metavar="DP,SP",
        help="device layout for --regions-file: data-parallel x position-parallel "
        "sizes; only 1,1 (one device) is ported [1,1]",
    )
    p.add_argument(
        "--strategy",
        default="auto",
        choices=("auto", "position", "interval", "resident", "batched"),
        help="--regions-file strategy: 'position'/'interval' gather "
        "per-window candidates host-side; 'resident' places the index ONCE "
        "in device memory and serves every window from whole-record "
        "outputs; 'batched' serves all of a record's windows with one "
        "launch of each fused-kernel pass. 'auto' picks resident for "
        "dense/many-window batches, batched for scattered windows on a CUDA "
        "device, else position [auto]",
    )
    p.add_argument("-o", dest="out_file", required=True, help="output file")
    p.add_argument(
        "-m",
        dest="membership",
        action="store_true",
        help="perform the membership query (instead of conservation query)",
    )
    p.add_argument(
        "--backend",
        default="auto",
        choices=["auto", "fused", "torch", "numpy"],
        help="fused: the CUDA kernel; torch: diff-array tensor ops; numpy: host [auto = fused]",
    )
    p.add_argument(
        "--device",
        default="cuda",
        choices=["cuda", "cpu"],
        help="device to query on; cuda fails where no GPU exists [cuda]",
    )
    p.add_argument("--profile", metavar="DIR", default=None, help="write a torch.profiler trace")
    p.add_argument("--stats", action="store_true", help="print per-query stats to stderr")
    p.add_argument(
        "--force",
        action="store_true",
        help="run even if the index kind (conservation/membership) does not match the query flag",
    )


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="memo-tpu-torch",
        description="MEMO pangenome k-mer membership/conservation queries on PyTorch and CUDA",
    )
    sub = ap.add_subparsers(dest="command", required=True)
    ref_cli._add_index(sub)
    for action in sub.choices["index"]._actions:
        if action.dest == "profile":
            action.help = "write a torch.profiler trace"
    _add_query(sub)
    ref_cli._add_view(sub)
    ref_cli._add_extract(sub)
    return ap


def cmd_index(args) -> int:
    profile, args.profile = args.profile, None  # traced here, not by memo_tpu
    with trace_context(profile):
        return ref_cli.cmd_index(args)


def pick_batch_strategy(store, regions, device) -> str:
    """Resolve ``--strategy auto`` for a regions batch with memo_tpu's rules
    (memo_tpu/cli.py:256-287): resident when the windows cover at least 1/16
    of the records they touch or there are at least 8 windows per record
    (one whole-record dispatch serves them all); else, for scattered small
    windows, batched where memo_tpu sees a single TPU, which here reads "the
    query device is CUDA"; else position."""
    by_record: dict[str, int] = {}
    for record, qs, qe in regions:
        by_record[record] = by_record.get(record, 0) + max(qe - qs, 0)
    queried = sum(by_record.values())
    touched = sum(int(store.record_lens[store.record_index(r)]) for r in by_record)
    if queried * 16 >= touched or len(regions) >= 8 * len(by_record):
        return "resident"
    if torch.device(device).type == "cuda":
        return "batched"
    return "position"


def _query_regions(args, device) -> int:
    from memo_tpu.query.output import write_conservation, write_membership
    from memo_tpu_torch.parallel import ResidentShardedQuery, ShardedQuery, check_layout
    from memo_tpu_torch.query.engine import QueryEngine, parse_region

    with open(args.regions_file) as fh:
        regions = [parse_region(line.strip()) for line in fh if line.strip()]
    try:
        mesh = check_layout(args.mesh.split(",")) if args.mesh else (1, 1)
    except ValueError as err:
        raise SystemExit(f"--mesh {args.mesh}: {err}") from None
    store = ref_cli.load_store(args.index, args.num_docs, args.membership, force=args.force)
    strategy = args.strategy
    if strategy == "auto":
        strategy = pick_batch_strategy(store, regions, device)
        log.info("--strategy auto resolved to %r", strategy)
    with trace_context(args.profile):
        if strategy == "resident":
            # One placement serves every queried record, and all windows of a
            # (record, k) are slices of one whole-record dispatch.
            uniq = list(dict.fromkeys(record for record, _, _ in regions))
            placement = {"record": uniq[0]} if len(uniq) == 1 else {"records": uniq}
            rq = ResidentShardedQuery(store, device, k_max=max(args.k, 1024), **placement)
            fn = rq.membership if args.membership else rq.conservation
            results = [fn(qs, qe, args.k, record=record) for record, qs, qe in regions]
        elif strategy == "batched":
            engine = QueryEngine(store, backend=args.backend, device=device)
            fn = engine.membership_batch if args.membership else engine.conservation_batch
            by_rec: dict[str, list[tuple[int, int]]] = {}
            for record, qs, qe in regions:
                by_rec.setdefault(record, []).append((qs, qe))
            outs = {}
            for record, wins in by_rec.items():
                for (qs, qe), o in zip(wins, fn(record, wins, args.k)):
                    outs[(record, qs, qe)] = o
            results = [outs[key] for key in regions]
        else:
            sq = ShardedQuery(store, device, strategy=strategy)
            results = (sq.membership if args.membership else sq.conservation)(regions, args.k)
    write = write_membership if args.membership else write_conservation
    for (record, qs, qe), res in zip(regions, results):
        write(np.asarray(res), f"{args.out_file}.{record}_{qs}_{qe}.txt")
    log.info("wrote %d region outputs (mesh=%s)", len(regions), {"dp": mesh[0], "sp": mesh[1]})
    return 0


def cmd_query(args) -> int:
    from memo_tpu.query.output import write_conservation, write_membership
    from memo_tpu_torch.query.engine import QueryEngine, parse_region
    from memo_tpu_torch.utils.device import resolve_device

    if (args.region is None) == (args.regions_file is None):
        raise SystemExit("exactly one of -r or --regions-file is required")
    device = resolve_device(args.device)
    if args.regions_file:
        return _query_regions(args, device)
    store = ref_cli.load_store(args.index, args.num_docs, args.membership, force=args.force)
    engine = QueryEngine(store, backend=args.backend, device=device)
    record, qs, qe = parse_region(args.region)
    with trace_context(args.profile):
        if args.membership:
            write_membership(engine.membership(record, qs, qe, args.k), args.out_file)
        else:
            write_conservation(engine.conservation(record, qs, qe, args.k), args.out_file)
    if args.stats:
        print(f"stats: {engine.last_stats.as_dict()}", file=sys.stderr)
    return 0


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "index":
        return cmd_index(args)
    if args.command == "query":
        return cmd_query(args)
    if args.command == "view":
        return ref_cli.cmd_view(args)
    if args.command == "extract":
        return ref_cli.cmd_extract(args)
    raise SystemExit(f"unknown command {args.command}")


if __name__ == "__main__":
    raise SystemExit(main())
