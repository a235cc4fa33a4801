"""memo-tpu-torch CLI: ``python -m memo_tpu_torch {index, query, view, extract}``.

``index``, ``view`` and ``extract`` are memo_tpu's own commands (host only).
``query -r`` takes memo_tpu's flags and runs on this package's engine, with
``--device {cuda,cpu}`` (default cuda; no GPU is an error) and
``--backend {auto,fused,torch,numpy}``. Outputs are byte-identical to
``python -m memo_tpu query``.
"""

from __future__ import annotations

import argparse
import sys

from memo_tpu import cli as ref_cli
from memo_tpu_torch.utils.profiling import trace_context


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
    p.add_argument("--regions-file", default=None, help="batch mode (not yet ported; raises)")
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


def cmd_query(args) -> int:
    from memo_tpu.query.output import write_conservation, write_membership
    from memo_tpu_torch.query.engine import QueryEngine, parse_region
    from memo_tpu_torch.utils.device import resolve_device

    if (args.region is None) == (args.regions_file is None):
        raise SystemExit("exactly one of -r or --regions-file is required")
    if args.regions_file:
        raise SystemExit(
            "--regions-file is not yet ported to memo_tpu_torch "
            "(ROADMAP.md queue 1, remaining item 7: --regions-file)"
        )
    device = resolve_device(args.device)
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
