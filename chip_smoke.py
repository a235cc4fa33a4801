"""Smoke run of memo_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA device

Builds the CUDA kernels from ``memo_tpu_torch/csrc`` (v1 ``fused_query`` and
v2 ``fused_query_v2``), holds each against its plain PyTorch version for one
window and for a batch of windows, and drives the query paths: the
single-window path through the CLI at the headline size (2 Mbp pivot, 16
genomes, k=31); the batched-windows path (16 staggered 1 Mbp windows, one
launch per kernel pass, v1 and v2) through the engine and through the CLI's
``--regions-file`` with every strategy; the HPRC-width store (90 genomes,
~75M intervals) and a 160-genome store through the stratified engine with
both kernels; and a membership store. Every output is checked exactly
against the reference loop of bench.py, the port's single-window outputs or
the port's numpy engine. Each phase prints one line; the last line is
``{"ok": true, "device": {...}}``. Any failure raises, so the script exits
non-zero and prints no result. It exits non-zero at once where no CUDA
device is available.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 12345
KERNEL_REPS = 20  # launches per CUDA-event timing
WALL_REPS = 10  # timed end-to-end queries (median), after one warm-up
HPRC_REPS = 5
MEMB_LEN = 200_000  # membership store pivot length
MEMB_DOCS = 16
BATCH_WINDOWS, BATCH_LEN = 16, 1 << 20  # bench.py:632-636
WIDE_DOCS, WIDE_LEN = 160, 1 << 19  # bench.py:263-265


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def emit(phase: str, **fields) -> None:
    print(f"{phase} {json.dumps(fields)}", flush=True)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def kernel_ms(fn, reps: int = KERNEL_REPS) -> float:
    """Mean device time of one call of ``fn`` (CUDA events over ``reps``
    back-to-back calls, after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def wall_median_s(fn, device: torch.device, reps: int = WALL_REPS) -> float:
    """Median host-clock seconds of ``fn`` with the device synchronised
    before and after each call, after one warm-up call."""
    fn()
    sync(device)
    walls = []
    for _ in range(reps):
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()


# ---------------------------------------------------------------- phases
def phase_env() -> str:
    from memo_tpu_torch.ops._build import _nvcc

    nvcc = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True, check=True)
    try:
        import triton

        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    card = gpu_name_and_power()
    emit(
        "phase0_env",
        python=sys.version.split()[0],
        torch=torch.__version__,
        cuda=torch.version.cuda,
        nvcc=nvcc.stdout.strip().splitlines()[-1],
        triton=triton_version,
        device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(),
    )
    print(card, flush=True)
    return card


def phase_build() -> None:
    from memo_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.build_library()
    seconds = time.perf_counter() - t0
    _build.load_library()
    log = (lib.parent / "build.log").read_text() if (lib.parent / "build.log").exists() else ""
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "Compiling entry" in ln]
    emit("phase1_build", seconds=seconds, library=os.path.relpath(lib), ptxas=ptxas)


def random_streams(rng, L: int, C: int, n_events: int, device, tile=None, n_win: int = 1):
    """Two sorted event streams over a window of L positions: events at
    random positions in [0, L) with random columns (val 0 = inert), then a
    dead tail parked at L_pad, as ``prepare_streams`` lays them out; 1-D for
    one window, one row per window (each its own events) for n_win > 1."""
    from memo_tpu_torch.ops.fused_query import Streams, kernel_constants

    tile = tile or kernel_constants(C)
    l_pad = -(-L // tile) * tile
    bounds = np.arange(0, l_pad + 1, tile)
    rows = [[] for _ in range(6)]
    for _ in range(n_win):
        for j in (0, 3):
            pos = np.sort(rng.integers(0, L, n_events)).astype(np.int32)
            pos = np.concatenate([pos, np.full(n_events // 8, l_pad, np.int32)])
            rows[j].append(pos)
            rows[j + 1].append(rng.integers(0, C + 1, pos.shape[0]).astype(np.int32))
            rows[j + 2].append(np.searchsorted(pos, bounds, side="left").astype(np.int32))
    prefix = rng.integers(0, 3, (n_win, C)).astype(np.int32)
    pick = (lambda a: a[0]) if n_win == 1 else np.stack
    parts = [torch.from_numpy(pick(r)).to(device) for r in rows]
    return Streams(*parts, L, tile), torch.from_numpy(pick(prefix)).to(device)


def kernel_cases(device, run, reference, tile_of, n_wins) -> list[int]:
    """``run`` against ``reference`` on random streams at C = 16/90/160/257,
    the lengths below and ``n_wins`` windows per launch: every value is an
    integer, so the two must be equal. Returns the errors."""
    rng = np.random.default_rng(SEED)
    errors = []
    for C in (16, 90, 160, 257):
        for L, per_pos in ((1, 3), (1000, 3), (4096 + 17, 30), (300_001, 2), (2048, 0)):
            for n_win in n_wins:
                for membership in (False, True):
                    streams, prefix = random_streams(rng, L, C, L * per_pos, device, tile_of(C),
                                                     n_win)
                    got = run(streams, prefix, n_docs=C, membership=membership)
                    want = reference(streams, prefix, n_docs=C, membership=membership)
                    sync(device)
                    where = f"{run.__name__} C={C} L={L} Q={n_win} membership={membership}"
                    check(got.dtype == want.dtype and got.shape == want.shape, f"{where} shape/dtype")
                    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
                    check(err == 0, f"kernel != plain: {where}")
                    errors.append(err)
    return errors


def phase_kernels(device) -> int:
    """The v1 kernel against fused_query_reference, one window per launch."""
    from memo_tpu_torch.ops.fused_query import fused_query, fused_query_reference, kernel_constants

    errors = kernel_cases(device, fused_query, fused_query_reference, kernel_constants, (1,))
    emit("phase2_kernels", cases=len(errors), max_abs_err=max(errors),
         widths=[16, 90, 160, 257], lengths=[1, 1000, 4113, 300001, 2048])
    return max(errors)


def phase_kernels_v2_and_batch(device) -> tuple[int, int]:
    """The v2 kernel against its plain version with 1 and 3 windows per
    launch, and the v1 kernel with 3 windows per launch."""
    from memo_tpu_torch.ops.fused_query import fused_query, fused_query_reference, kernel_constants
    from memo_tpu_torch.ops.fused_query_v2 import (
        fused_query_v2, fused_query_v2_reference, kernel_constants_v2,
    )

    v2 = kernel_cases(device, fused_query_v2, fused_query_v2_reference, kernel_constants_v2, (1, 3))
    v1 = kernel_cases(device, fused_query, fused_query_reference, kernel_constants, (3,))
    emit("phase6_kernels_v2_and_batch", v2_cases=len(v2), v2_max_abs_err=max(v2),
         v1_batch_cases=len(v1), v1_batch_max_abs_err=max(v1), windows_per_launch={"v2": [1, 3],
         "v1": [3]}, widths=[16, 90, 160, 257], lengths=[1, 1000, 4113, 300001, 2048])
    return max(v2), max(v1)


def time_kernel_against_plain(engine, record: str, qs: int, qe: int, k: int, version: str = "v1"):
    """Kernel and plain-version device times on the streams that ``engine``
    builds for one window with kernel ``version``, after checking they agree
    exactly."""
    from memo_tpu_torch.ops.fused_query import fused_query_reference, prepare_streams
    from memo_tpu_torch.query.engine import KERNELS
    from memo_tpu.query.engine import _next_pow2

    run, constants = KERNELS[version]
    n = engine.n_docs
    mlo, mhi, plo, phi, prefix = engine._window_params(record, qs, qe, k)
    M = min(_next_pow2(max(mhi - mlo, phi - plo, 1)), engine.max_intervals)
    streams = prepare_streams(
        *engine._d, mlo, mhi, plo, phi, qs, k, M=M, L=qe - qs, C=n, tile=constants(n)
    )
    prefix_t = torch.from_numpy(prefix.astype(np.int32)).to(engine.device)
    got = run(streams, prefix_t, n_docs=n, membership=False)
    want = fused_query_reference(streams, prefix_t, n_docs=n, membership=False)
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    check(err == 0, f"{version} kernel != plain on the engine's streams (C={n})")
    ms = kernel_ms(lambda: run(streams, prefix_t, n_docs=n, membership=False))
    plain_ms = kernel_ms(lambda: fused_query_reference(streams, prefix_t, n_docs=n, membership=False))
    setup_ms = kernel_ms(lambda: prepare_streams(
        *engine._d, mlo, mhi, plo, phi, qs, k, M=M, L=qe - qs, C=n, tile=constants(n)
    ))
    events = int(streams.off_m[-1]) + int(streams.off_p[-1])
    return {"version": version, "C": n, "L": qe - qs, "M": M, "events": events,
            "tile": streams.tile, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "stream_setup_ms": setup_ms}


def phase_headline(device, tmp: str):
    import bench
    from memo_tpu.query.output import format_conservation
    from memo_tpu_torch import cli
    from memo_tpu_torch.ops.fused_query import fused_query
    from memo_tpu_torch.query.engine import QueryEngine

    L, K = bench.PIVOT_LEN, bench.K
    t0 = time.perf_counter()
    store = bench.build_store(np.random.default_rng(SEED))
    build_s = time.perf_counter() - t0
    npz = os.path.join(tmp, "headline.npz")
    out = os.path.join(tmp, "cons.txt")
    store.save(npz)

    fused_query.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(["query", "-b", npz, "-k", str(K), "-r", f"chr1:0-{L}", "-o", out,
                   "--device", device.type, "--stats"])
    cli_s = time.perf_counter() - t0
    launches = fused_query.launches
    check(rc == 0, "CLI query exit code")
    check(launches > 0, "the CLI query launched the fused kernel")

    windows = [(w, min(w + bench.WINDOW, L)) for w in range(0, L, bench.WINDOW)]
    t0 = time.perf_counter()
    ref = np.concatenate([bench.reference_query_np(store, qs, qe, K) for qs, qe in windows])
    ref_s = time.perf_counter() - t0
    with open(out, "rb") as fh:
        got_bytes = fh.read()
    check(got_bytes == format_conservation(ref), "CLI output bytes == reference loop")

    mbp_s = {}
    for backend in ("fused", "torch"):
        eng = QueryEngine(store, backend=backend, device=device, chunk_positions=L,
                          device_output=True)
        dt = wall_median_s(lambda: eng.conservation("chr1", 0, L, K), device)
        mbp_s[backend] = L / dt / 1e6

    fused = QueryEngine(store, backend="fused", device=device, chunk_positions=L)
    oracle = QueryEngine(store, backend="numpy", device="cpu")
    for k in (21, 51, 101):
        check(np.array_equal(fused.conservation("chr1", 0, L, k), oracle.conservation("chr1", 0, L, k)),
              f"fused == numpy engine at k={k}")

    # Layer breakdown of one query: host range search and prefix, stream
    # set-up and kernel (device time), result copy and text formatting.
    t0 = time.perf_counter()
    fused._window_params("chr1", 0, L, K)
    host_ms = (time.perf_counter() - t0) * 1e3
    kern = time_kernel_against_plain(fused, "chr1", 0, L, K)
    kern_v2 = time_kernel_against_plain(fused, "chr1", 0, L, K, version="v2")
    res = fused.conservation("chr1", 0, L, K)
    t0 = time.perf_counter()
    format_conservation(res)
    format_ms = (time.perf_counter() - t0) * 1e3
    emit("phase3_headline", intervals=store.num_intervals, n_docs=store.n_docs, L=L, k=K,
         store_build_s=build_s, cli_query_s=cli_s, launches=launches, exact_cli_bytes=True,
         reference_loop_s=ref_s, mbp_s=mbp_s, k_sweep_exact=[21, 51, 101],
         layers_ms={"host_ranges_prefix": host_ms, "stream_setup": kern["stream_setup_ms"],
                    "kernel": kern["ms"], "format_output": format_ms},
         kernel=kern, kernel_v2=kern_v2)
    return launches, kern, kern_v2, store, mbp_s


def batch_windows(pivot_len: int) -> list[tuple[int, int]]:
    """16 staggered 1 Mbp windows over the pivot (bench.py:632-636)."""
    span = pivot_len - BATCH_LEN
    return [(round(i * span / (BATCH_WINDOWS - 1)), round(i * span / (BATCH_WINDOWS - 1)) + BATCH_LEN)
            for i in range(BATCH_WINDOWS)]


def phase_batched(device, store) -> list[np.ndarray]:
    """conservation_batch at the headline with v1 and v2: one launch for the
    whole batch, every window == the single-window output, window 3's first
    16 Kbp == the reference loop. Returns the single-window outputs."""
    import bench
    from memo_tpu_torch.ops.fused_query import fused_query
    from memo_tpu_torch.ops.fused_query_v2 import fused_query_v2
    from memo_tpu_torch.query.engine import QueryEngine

    wins = batch_windows(bench.PIVOT_LEN)
    sub = 1 << 14
    ref = bench.reference_query_np(store, wins[3][0], wins[3][0] + sub, bench.K)
    fields, singles = {}, None
    for version in ("v1", "v2"):
        eng = QueryEngine(store, backend="fused", device=device, chunk_positions=bench.PIVOT_LEN,
                          device_output=True, stratify=False, kernel_version=version)
        fused_query.launches = fused_query_v2.launches = 0
        outs = eng.conservation_batch("chr1", wins, bench.K)
        sync(device)
        launches = {"v1": fused_query.launches, "v2": fused_query_v2.launches}
        check(launches == {"v1": int(version == "v1"), "v2": int(version == "v2")},
              f"{version} batch of {len(wins)} windows ran as one launch: {launches}")
        single = [eng.conservation("chr1", qs, qe, bench.K) for qs, qe in wins]
        for (qs, qe), got, one in zip(wins, outs, single):
            check(torch.equal(got, one), f"{version} batch window {qs}-{qe} == single window")
        check(np.array_equal(outs[3][:sub].cpu().numpy(), ref), f"{version} window 3 == reference loop")
        batch_s = wall_median_s(lambda: eng.conservation_batch("chr1", wins, bench.K), device)
        single_s = wall_median_s(lambda: eng.conservation("chr1", *wins[0], bench.K), device)
        fields[version] = {"launches": launches[version], "batch_wall_ms": batch_s * 1e3,
                           "per_window_ms": batch_s * 1e3 / len(wins),
                           "single_window_ms": single_s * 1e3,
                           "batch_mbp_s": len(wins) * BATCH_LEN / batch_s / 1e6}
        if singles is None:
            singles = [o.cpu().numpy() for o in single]
    emit("phase7_batched", windows=len(wins), window_len=BATCH_LEN, k=bench.K,
         exact_vs_single=True, exact_window3_vs_reference=True, **fields)
    return singles


def phase_hprc(device):
    import bench
    from memo_tpu_torch.query.engine import QueryEngine

    L, K = bench.LARGE_PIVOT_LEN, bench.K
    t0 = time.perf_counter()
    store = bench.build_large_store(np.random.default_rng(SEED))
    build_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = QueryEngine(store, backend="fused", device=device, chunk_positions=L,
                      max_intervals_per_chunk=1 << 25, device_output=True)
    init_s = time.perf_counter() - t0
    check(eng._children is not None, "HPRC-width store is stratified")
    dt = wall_median_s(lambda: eng.conservation("chr1", 0, L, K), device, reps=HPRC_REPS)
    out = eng.conservation("chr1", 0, L, K).cpu().numpy()
    stats = eng.last_stats.as_dict()
    peak = torch.cuda.max_memory_allocated()
    for sub_qs in (bench.WINDOW, L - (1 << 15) - 7):
        sub = (sub_qs, sub_qs + (1 << 15))
        check(np.array_equal(out[sub[0]:sub[1]], bench.reference_query_np(store, *sub, K)),
              f"HPRC spot window {sub}")
    kern = time_kernel_against_plain(eng._children[0][1], "chr1", 0, L, K)
    emit("phase4_hprc", intervals=store.num_intervals, n_docs=store.n_docs, L=L, k=K,
         store_build_s=build_s, engine_init_s=init_s, mbp_s=L / dt / 1e6, last_stats=stats,
         buckets=[lb for lb, _ in eng._children], peak_device_bytes=peak,
         spot_windows_exact=2, kernel=kern)
    return kern, store


@contextlib.contextmanager
def kernel_env(version: str | None):
    """MEMO_TPU_PALLAS_KERNEL set to ``version`` (unset for None) inside."""
    old = os.environ.pop("MEMO_TPU_PALLAS_KERNEL", None)
    if version:
        os.environ["MEMO_TPU_PALLAS_KERNEL"] = version
    try:
        yield
    finally:
        os.environ.pop("MEMO_TPU_PALLAS_KERNEL", None)
        if old is not None:
            os.environ["MEMO_TPU_PALLAS_KERNEL"] = old


def phase_v2_full_width(device, large_store) -> list[dict]:
    """The stratified engine with kernel_version="v2" at the n=90 store
    (bucket 0 runs at k=31) and at a 160-genome store (bench.py:255-292):
    spot windows exact against the reference loop; v2's, its plain
    version's and v1's device times on the same window."""
    import bench
    from memo_tpu.index.builder import store_from_ms
    from memo_tpu_torch.ops.fused_query_v2 import fused_query_v2
    from memo_tpu_torch.query.engine import QueryEngine

    K = bench.K
    t0 = time.perf_counter()
    ms = bench.synth_ms(np.random.default_rng(SEED), WIDE_LEN, WIDE_DOCS - 1, K, gap=30)
    wide = store_from_ms([ms], ["chr1"], [WIDE_LEN], WIDE_DOCS, "conservation")
    del ms
    wide_build_s = time.perf_counter() - t0
    L90 = bench.LARGE_PIVOT_LEN
    cells = (
        ("n90", large_store, L90, ((bench.WINDOW, 1 << 15), (L90 - (1 << 15) - 7, 1 << 15))),
        ("n160", wide, WIDE_LEN, ((1 << 16, 1 << 14),)),
    )
    fields, kernels = {}, []
    for name, store, L, spots in cells:
        eng = QueryEngine(store, backend="fused", device=device, chunk_positions=L,
                          max_intervals_per_chunk=1 << 25, device_output=True, kernel_version="v2")
        fused_query_v2.launches = 0
        out = eng.conservation("chr1", 0, L, K).cpu().numpy()
        launches = fused_query_v2.launches
        check(launches > 0, f"{name}: the v2 engine launched the v2 kernel")
        for qs, n in spots:
            check(np.array_equal(out[qs:qs + n], bench.reference_query_np(store, qs, qs + n, K)),
                  f"{name} v2 spot window {qs}-{qs + n}")
        dt = wall_median_s(lambda: eng.conservation("chr1", 0, L, K), device, reps=HPRC_REPS)
        child = eng._children[0][1] if eng._children else eng
        kern = {v: time_kernel_against_plain(child, "chr1", 0, L, K, version=v) for v in ("v2", "v1")}
        kernels += kern.values()
        fields[name] = {"intervals": store.num_intervals, "n_docs": store.n_docs, "L": L,
                        "stratified": eng._children is not None, "launches": launches,
                        "spot_windows_exact": len(spots), "mbp_s": L / dt / 1e6,
                        "v2_ms": kern["v2"]["ms"], "plain_ms": kern["v2"]["plain_ms"],
                        "v1_ms": kern["v1"]["ms"], "kernel_v2": kern["v2"],
                        "kernel_v1": kern["v1"]}
        del eng, child
        torch.cuda.empty_cache()
    emit("phase8_v2_full_width", k=K, wide_store_build_s=wide_build_s, **fields)
    return kernels


def phase_cli_regions(device, tmp: str, singles: list[np.ndarray], torch_mbp_s: float) -> int:
    """``query --regions-file`` with the 16 batch windows at the headline,
    through strategies auto (resident here), batched, batched with v2 and
    position: every file byte-identical across the runs and to
    write_conservation of the single-window outputs. Returns the v2 run's
    launches."""
    import bench
    from memo_tpu.query.output import format_conservation
    from memo_tpu_torch import cli
    from memo_tpu_torch.ops.fused_query import fused_query
    from memo_tpu_torch.ops.fused_query_v2 import fused_query_v2

    wins = batch_windows(bench.PIVOT_LEN)
    npz = os.path.join(tmp, "headline.npz")  # written by phase 3
    regions = os.path.join(tmp, "regions.txt")
    with open(regions, "w") as fh:
        fh.writelines(f"chr1:{qs}-{qe}\n" for qs, qe in wins)
    want = [format_conservation(o) for o in singles]
    records: list[str] = []
    handler = logging.Handler()
    handler.emit = lambda rec: records.append(rec.getMessage())
    cli.log.addHandler(handler)
    runs = {}
    try:
        for name, strategy, version, expect in (
            ("auto", "auto", None, (0, 0)),
            ("batched", "batched", None, (1, 0)),
            ("batched_v2", "batched", "v2", (0, 1)),
            ("position", "position", None, (0, 0)),
        ):
            out = os.path.join(tmp, f"regions_{name}")
            fused_query.launches = fused_query_v2.launches = 0
            t0 = time.perf_counter()
            with kernel_env(version):
                rc = cli.main(["query", "-b", npz, "-k", str(bench.K), "--regions-file", regions,
                               "-o", out, "--strategy", strategy, "--device", device.type])
            wall = time.perf_counter() - t0
            launches = (fused_query.launches, fused_query_v2.launches)
            check(rc == 0, f"CLI --regions-file --strategy {name} exit code")
            check(launches == expect, f"CLI {name}: launches (v1, v2) {launches} != {expect}")
            for (qs, qe), w in zip(wins, want):
                with open(f"{out}.chr1_{qs}_{qe}.txt", "rb") as fh:
                    check(fh.read() == w, f"CLI {name} window {qs}-{qe} bytes == single window")
            runs[name] = {"cli_s": wall, "launches_v1": launches[0], "launches_v2": launches[1]}
    finally:
        cli.log.removeHandler(handler)
    check("--strategy auto resolved to 'resident'" in records, f"auto resolved to resident: {records}")
    emit("phase9_cli_regions", windows=len(wins), strategies=runs, auto_resolved="resident",
         byte_identical=True, torch_backend_headline_mbp_s=torch_mbp_s)
    return runs["batched_v2"]["launches_v2"]


def phase_membership(device) -> None:
    from memo_tpu.index.builder import store_from_ms
    from memo_tpu_torch.query.engine import QueryEngine

    rng = np.random.default_rng(SEED)
    ms = rng.integers(0, 50, size=(MEMB_LEN, MEMB_DOCS - 1)).astype(np.int32)
    # Matching statistics drop by at most 1 per position: out[p] = min_{q>=p}(ms[q]+q) - p.
    idx = np.arange(MEMB_LEN, dtype=np.int64)[:, None]
    ms = (np.minimum.accumulate((ms + idx)[::-1])[::-1] - idx).astype(np.int32)
    store = store_from_ms([ms], ["chr1"], [MEMB_LEN], MEMB_DOCS, "membership")
    fused = QueryEngine(store, backend="fused", device=device)
    oracle = QueryEngine(store, backend="numpy", device="cpu")
    for qs, qe, k in ((0, MEMB_LEN, 31), (12_345, 150_001, 7)):
        got = fused.membership("chr1", qs, qe, k)
        check(got.dtype == np.int8 and got.shape == (qe - qs, MEMB_DOCS), "membership shape/dtype")
        check(np.array_equal(got, oracle.membership("chr1", qs, qe, k)),
              f"membership fused == numpy engine {qs}-{qe} k={k}")
    emit("phase5_membership", intervals=store.num_intervals, n_docs=MEMB_DOCS, L=MEMB_LEN,
         exact=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke needs a CUDA device",
              file=sys.stderr)
        return 1
    device = torch.device("cuda")
    card = phase_env()
    phase_build()
    max_err = phase_kernels(device)
    v2_err, v1_batch_err = phase_kernels_v2_and_batch(device)
    with tempfile.TemporaryDirectory() as tmp:
        launches, head, head_v2, store, mbp_s = phase_headline(device, tmp)
        singles = phase_batched(device, store)
        del store
        v2_launches = phase_cli_regions(device, tmp, singles, mbp_s["torch"])
    hprc, large = phase_hprc(device)
    wide = phase_v2_full_width(device, large)
    del large
    phase_membership(device)
    errs = {v: [kern["max_abs_err"] for kern in wide if kern["version"] == v] for v in ("v1", "v2")}
    print(json.dumps({"kernels": [{
        "name": "fused_query",
        "route": "cuda",
        "source": "memo_tpu_torch/csrc/fused_query.cu",
        "replaces": "memo_tpu/ops/pallas_query.py:236",
        "launches": launches,
        "max_abs_err": max(max_err, v1_batch_err, head["max_abs_err"], hprc["max_abs_err"],
                           *errs["v1"]),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
    }, {
        "name": "fused_query_v2",
        "route": "cuda",
        "source": "memo_tpu_torch/csrc/fused_query_v2.cu",
        "replaces": "memo_tpu/ops/pallas_query_v2.py:301",
        "launches": v2_launches,
        "max_abs_err": max(v2_err, head_v2["max_abs_err"], *errs["v2"]),
        "ms": head_v2["ms"],
        "plain_ms": head_v2["plain_ms"],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
