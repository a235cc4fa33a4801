"""memo-tpu-torch CLI: ``python -m memo_tpu_torch {index, query, view, extract}``.

The same subcommands and flags as ``python -m memo_tpu``, and the same output
bytes. ``index``, ``view`` and ``extract`` run on the host, on the port's own
copies of memo_tpu's builder, plotter and compat writers (memo_tpu/cli.py).
``query`` (``-r`` or ``--regions-file``) runs on this package's engine, with
``--device {cuda,cpu}`` (default cuda; no GPU is an error) and ``--backend
{auto,fused,torch,numpy}``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from memo_tpu_torch.utils.logging import get_logger
from memo_tpu_torch.utils.profiling import GLOBAL_TIMES, stage_timer, trace_context

log = get_logger(__name__)


def _add_index(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser(
        "index", help="index pangenome into MEMO membership or conservation indexes"
    )
    p.add_argument("-g", dest="genome_list", required=True, help="document list (line 1 = pivot)")
    p.add_argument("-o", dest="output_dir", default=".", help="output directory ['.']")
    p.add_argument("-p", dest="prefix", required=True, help="output file prefix")
    p.add_argument(
        "-m", dest="membership", action="store_true", help="make membership index"
    )
    p.add_argument(
        "--ms-backend",
        default="auto",
        choices=["auto", "native", "python", "sa"],
        help="matching-statistics engine: auto (automaton when the document "
        "fits the RAM budget, else partitioned suffix-array groups), "
        "native/python (automaton), sa (suffix array) [auto]",
    )
    p.add_argument(
        "--ms-budget-mb",
        type=int,
        default=None,
        metavar="MB",
        help="RAM budget per matching-statistics group build; documents "
        "larger than the budget are partitioned at record boundaries and "
        "max-merged (exact) [8192]",
    )
    p.add_argument(
        "--ms-pooled",
        default="auto",
        choices=["auto", "on", "off"],
        help="pool documents into shared colored-GSA suffix-array groups "
        "(one SA per RAM-budget group serves every document in it; fastest "
        "at pangenome widths). auto estimates from input sizes [auto]",
    )
    p.add_argument(
        "--emit-compat",
        action="store_true",
        help="also write reference-format artifacts (fai, dap.txt, bed, parquet)",
    )
    p.add_argument("--no-cache", action="store_true", help="disable resumable MS caching")
    p.add_argument(
        "--jobs", type=int, default=1, help="parallel per-genome MS builds [1]"
    )
    p.add_argument(
        "--preserve-case",
        action="store_true",
        help="byte-literal matching like MONI (the reference pipeline never "
        "case-folds, so soft-masked lowercase only matches lowercase — see "
        "docs/MONI_PARITY.md); default uppercases pivot and documents first",
    )
    p.add_argument("--profile", metavar="DIR", default=None, help="write a torch.profiler trace")


def _add_extract(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser(
        "extract",
        help="extract region chr:start-end from an overlap MEM index "
        "(legacy omem extract, reference extract.sh)",
    )
    p.add_argument(
        "-b", dest="index", required=True, help="MEMO index (.npz native, .parquet or .bed compat)"
    )
    p.add_argument(
        "-r", dest="region", required=True, help="target query region chr:start-end (0-indexed, half open)"
    )
    p.add_argument("-o", dest="output_dir", default=".", help="output directory ['.']")
    p.add_argument(
        "-n",
        dest="num_docs",
        type=int,
        default=None,
        help="total documents (only needed for .parquet/.bed inputs)",
    )


def _add_view(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser("view", help="plot sequence conservation")
    p.add_argument("-i", dest="in_file", required=True, help="input conservation.out")
    p.add_argument("-o", dest="out_file", required=True, help="output plot.png")
    p.add_argument(
        "-n", dest="num_docs", type=int, required=True, help="total number of documents"
    )
    p.add_argument("-b", dest="num_bins", type=int, default=500, help="genomic bins [500]")
    p.add_argument("-d", dest="dpi", type=int, default=600, help="plot DPI [600]")


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
        "sizes, one process per device: dp*sp > 1 runs under `torchrun "
        "--nproc-per-node dp*sp` (NCCL for --device cuda, gloo for cpu) "
        "[1,1 alone; 1,<ranks> under torchrun]",
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
    _add_index(sub)
    _add_query(sub)
    _add_view(sub)
    _add_extract(sub)
    return ap


def cmd_index(args) -> int:
    from memo_tpu_torch.index.builder import BuildConfig, build_index

    os.makedirs(args.output_dir, exist_ok=True)
    cfg = BuildConfig(
        kind="membership" if args.membership else "conservation",
        backend=args.ms_backend,
        ms_budget_bytes=args.ms_budget_mb << 20 if args.ms_budget_mb else None,
        uppercase=not args.preserve_case,
        workdir=None if args.no_cache else args.output_dir,
        emit_compat=args.emit_compat,
        compat_prefix=args.prefix,
        jobs=args.jobs,
        pooled={"auto": None, "on": True, "off": False}[args.ms_pooled],
    )
    with trace_context(args.profile):
        store = build_index(args.genome_list, cfg)
    out = os.path.join(args.output_dir, f"{args.prefix}.npz")
    store.save(out)
    log.info("index written: %s (%s)", out, store.stats())
    log.info("stage times: %s", GLOBAL_TIMES.report())
    print(f"DONE — index at {out}")
    return 0


def load_store(path: str, num_docs: int | None, membership: bool, force: bool = False):
    """The index at ``path`` (.npz native, .parquet or .bed compat), checked
    against the query's kind as memo_tpu checks it."""
    from memo_tpu_torch.index.store import IntervalStore

    kind = "membership" if membership else "conservation"
    if path.endswith(".npz"):
        store = IntervalStore.load(path)
        if num_docs is not None and num_docs != store.n_docs:
            log.warning("-n %d overrides stored n_docs=%d", num_docs, store.n_docs)
            store.n_docs = num_docs
        if store.kind != kind:
            # The native index stores its kind, so a mismatched query flag is
            # a user error that gives garbage-shaped output: refuse unless forced.
            msg = (
                f"index {path} is a {store.kind!r} index but the query "
                f"requests {kind!r} (-m flag mismatch)"
            )
            if not force:
                raise SystemExit(msg + "; pass --force to run anyway")
            log.warning("%s — forced; results follow the query flag", msg)
        return store
    from memo_tpu_torch.io import compat

    if num_docs is None:
        raise SystemExit("-n is required when querying a .parquet/.bed index")
    if path.endswith(".parquet"):
        return compat.read_parquet(path, num_docs, kind)
    if path.endswith(".bed"):
        return compat.read_bed(path, num_docs, kind)
    raise SystemExit(f"unrecognized index format: {path}")


def cmd_extract(args) -> int:
    from memo_tpu_torch.io.compat import write_extracted_bed
    from memo_tpu_torch.query.engine import parse_region

    record, qs, qe = parse_region(args.region)
    if args.index.endswith(".npz"):
        from memo_tpu_torch.index.store import IntervalStore

        store = IntervalStore.load(args.index)
    else:
        # kind/n_docs do not matter to extraction; placeholders load compat
        # inputs, with the record pushed into the reader.
        from memo_tpu_torch.io import compat

        reader = compat.read_parquet if args.index.endswith(".parquet") else compat.read_bed
        store = reader(args.index, args.num_docs or 2, "conservation", record=record)
    os.makedirs(args.output_dir, exist_ok=True)
    path = write_extracted_bed(store, record, qs, qe, args.output_dir)
    print(f"Output order MEM overlaps file: {path}")
    return 0


def cmd_view(args) -> int:
    from memo_tpu_torch.view.plot import save_conservation_plot

    save_conservation_plot(args.in_file, args.out_file, args.num_docs, args.num_bins, args.dpi)
    log.info("plot written: %s", args.out_file)
    return 0


def pick_batch_strategy(store, regions, device, n_ranks: int = 1) -> str:
    """Resolve ``--strategy auto`` for a regions batch with memo_tpu's rules
    (memo_tpu/cli.py:256-287): resident when the windows cover at least 1/16
    of the records they touch or there are at least 8 windows per record
    (one whole-record dispatch serves them all); else, for scattered small
    windows, batched where memo_tpu sees a single TPU, which here reads "the
    query device is CUDA and the layout has one rank"; else position."""
    by_record: dict[str, int] = {}
    for record, qs, qe in regions:
        by_record[record] = by_record.get(record, 0) + max(qe - qs, 0)
    queried = sum(by_record.values())
    touched = sum(int(store.record_lens[store.record_index(r)]) for r in by_record)
    if queried * 16 >= touched or len(regions) >= 8 * len(by_record):
        return "resident"
    if torch.device(device).type == "cuda" and n_ranks == 1:
        return "batched"
    return "position"


def _query_regions(args, device) -> int:
    """``query --regions-file``. Under torchrun every rank joins the process
    group, builds the mesh and computes; rank 0 alone writes the outputs."""
    import torch.distributed as dist

    from memo_tpu_torch.parallel import distributed, make_mesh
    from memo_tpu_torch.query.engine import parse_region
    from memo_tpu_torch.query.output import write_conservation, write_membership

    with open(args.regions_file) as fh:
        regions = [parse_region(line.strip()) for line in fh if line.strip()]
    created = distributed.launched() and distributed.initialize(device=device.type)
    try:
        try:
            dp_sp = [int(x) for x in args.mesh.split(",")] if args.mesh else [None, None]
            mesh = make_mesh(*dp_sp, device_type=device.type)
        except ValueError as err:
            raise SystemExit(f"--mesh {args.mesh}: {err}") from None
        results = _run_regions(args, regions, mesh)
        if not dist.is_initialized() or dist.get_rank() == 0:
            write = write_membership if args.membership else write_conservation
            for (record, qs, qe), res in zip(regions, results):
                write(np.asarray(res), f"{args.out_file}.{record}_{qs}_{qe}.txt")
            log.info("wrote %d region outputs (mesh=%s)", len(regions), mesh.shape)
    except BaseException:
        if created:
            dist.destroy_process_group()  # no barrier: the other ranks may be in a collective
        raise
    if created:
        distributed.shutdown()
    return 0


def _run_regions(args, regions, mesh) -> list:
    """Each region's output, by ``--strategy`` on ``mesh``."""
    from memo_tpu_torch.parallel import ResidentShardedQuery, ShardedQuery
    from memo_tpu_torch.query.engine import QueryEngine

    store = load_store(args.index, args.num_docs, args.membership, force=args.force)
    strategy = args.strategy
    if strategy == "auto":
        strategy = pick_batch_strategy(store, regions, mesh.device, mesh.dp * mesh.sp)
        log.info("--strategy auto resolved to %r", strategy)
    with trace_context(args.profile):
        if strategy == "resident":
            # One placement serves every queried record, and all windows of a
            # (record, k) are slices of one whole-record dispatch, brought to
            # the host in one copy.
            uniq = list(dict.fromkeys(record for record, _, _ in regions))
            placement = {"record": uniq[0]} if len(uniq) == 1 else {"records": uniq}
            rq = ResidentShardedQuery(store, mesh, k_max=max(args.k, 1024), **placement)
            fn = rq.membership_windows if args.membership else rq.conservation_windows
            return _by_record(regions, lambda record, wins: fn(wins, args.k, record=record))
        if strategy == "batched":
            # One device's engine; under a group every rank runs it on its own.
            engine = QueryEngine(store, backend=args.backend, device=mesh.device)
            fn = engine.membership_batch if args.membership else engine.conservation_batch
            return _by_record(regions, lambda record, wins: fn(record, wins, args.k))
        sq = ShardedQuery(store, mesh, strategy=strategy)
        return (sq.membership if args.membership else sq.conservation)(regions, args.k)


def _by_record(regions, run) -> list:
    """Each region's output, in the regions' order, from one ``run(record,
    windows)`` call per record over its windows."""
    by_rec: dict[str, list[tuple[int, int]]] = {}
    for record, qs, qe in regions:
        by_rec.setdefault(record, []).append((qs, qe))
    outs = {}
    for record, wins in by_rec.items():
        for (qs, qe), o in zip(wins, run(record, wins)):
            outs[(record, qs, qe)] = o
    return [outs[key] for key in regions]


def cmd_query(args) -> int:
    from memo_tpu_torch.query.output import format_conservation, format_membership
    from memo_tpu_torch.query.engine import QueryEngine, parse_region
    from memo_tpu_torch.utils.device import resolve_device

    if (args.region is None) == (args.regions_file is None):
        raise SystemExit("exactly one of -r or --regions-file is required")
    device = resolve_device(args.device)
    if args.regions_file:
        return _query_regions(args, device)
    with stage_timer("query.load_store"):
        store = load_store(args.index, args.num_docs, args.membership, force=args.force)
    with stage_timer("query.engine_setup"):
        engine = QueryEngine(store, backend=args.backend, device=device)
    record, qs, qe = parse_region(args.region)
    with trace_context(args.profile):
        with stage_timer("query.query"):
            if args.membership:
                res = engine.membership(record, qs, qe, args.k)
            else:
                res = engine.conservation(record, qs, qe, args.k)
        with stage_timer("query.format"):
            data = format_membership(res) if args.membership else format_conservation(res)
        with stage_timer("query.write"), open(args.out_file, "wb") as fh:
            fh.write(data)
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
        return cmd_view(args)
    if args.command == "extract":
        return cmd_extract(args)
    raise SystemExit(f"unknown command {args.command}")


if __name__ == "__main__":
    raise SystemExit(main())
