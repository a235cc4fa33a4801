"""Smoke run of memo_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA device

Builds the CUDA kernel from ``memo_tpu_torch/csrc``, holds it against its
plain PyTorch version, and drives the single-window query path through the
CLI at the headline size (2 Mbp pivot, 16 genomes, k=31), then the
HPRC-width store (90 genomes, ~75M intervals) through the stratified engine
and a membership store. Every output is checked exactly against the
reference loop of bench.py or against the port's numpy engine. Each phase
prints one line; the last line is ``{"ok": true, "device": {...}}``. Any
failure raises, so the script exits non-zero and prints no result. It exits
non-zero at once where no CUDA device is available.
"""

from __future__ import annotations

import json
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


def random_streams(rng, L: int, C: int, n_events: int, device):
    """Two sorted event streams over a window of L positions: events at
    random positions in [0, L) with random columns (val 0 = inert), then a
    dead tail parked at L_pad, as ``prepare_streams`` lays them out."""
    from memo_tpu_torch.ops.fused_query import Streams, kernel_constants

    tile = kernel_constants(C)
    l_pad = -(-L // tile) * tile
    bounds = torch.arange(l_pad // tile + 1, dtype=torch.int32, device=device) * tile
    parts = []
    for _ in range(2):
        pos = np.sort(rng.integers(0, L, n_events)).astype(np.int32)
        pos = np.concatenate([pos, np.full(n_events // 8, l_pad, np.int32)])
        val = rng.integers(0, C + 1, pos.shape[0]).astype(np.int32)
        pos_t = torch.from_numpy(pos).to(device)
        off = torch.searchsorted(pos_t, bounds, side="left", out_int32=True)
        parts.append((pos_t, torch.from_numpy(val).to(device), off))
    (pm, vm, om), (pp, vp, op) = parts
    prefix = torch.from_numpy(rng.integers(0, 3, C).astype(np.int32)).to(device)
    return Streams(pm, vm, om, pp, vp, op, L, tile), prefix


def phase_kernels(device) -> int:
    """The CUDA kernel against fused_query_reference on random streams:
    every value is an integer, so the two must be equal."""
    from memo_tpu_torch.ops.fused_query import fused_query, fused_query_reference

    rng = np.random.default_rng(SEED)
    cases = []
    for C in (16, 90, 160, 257):
        for L, per_pos in ((1, 3), (1000, 3), (4096 + 17, 30), (300_001, 2), (2048, 0)):
            for membership in (False, True):
                streams, prefix = random_streams(rng, L, C, L * per_pos, device)
                got = fused_query(streams, prefix, n_docs=C, membership=membership)
                want = fused_query_reference(streams, prefix, n_docs=C, membership=membership)
                sync(device)
                check(got.dtype == want.dtype and got.shape == want.shape, f"C={C} L={L} shape/dtype")
                err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
                check(err == 0, f"kernel != plain at C={C} L={L} membership={membership}")
                cases.append((C, L, membership, err))
    max_err = max(c[3] for c in cases)
    emit("phase2_kernels", cases=len(cases), max_abs_err=max_err,
         widths=[16, 90, 160, 257], lengths=[1, 1000, 4113, 300001, 2048])
    return max_err


def time_kernel_against_plain(engine, record: str, qs: int, qe: int, k: int):
    """Kernel and plain-version device times on the streams that ``engine``
    builds for one window, after checking they agree exactly."""
    from memo_tpu_torch.ops.fused_query import (
        fused_query, fused_query_reference, kernel_constants, prepare_streams,
    )
    from memo_tpu.query.engine import _next_pow2

    n = engine.n_docs
    mlo, mhi, plo, phi, prefix = engine._window_params(record, qs, qe, k)
    M = min(_next_pow2(max(mhi - mlo, phi - plo, 1)), engine.max_intervals)
    streams = prepare_streams(
        *engine._d, mlo, mhi, plo, phi, qs, k, M=M, L=qe - qs, C=n, tile=kernel_constants(n)
    )
    prefix_t = torch.from_numpy(prefix.astype(np.int32)).to(engine.device)
    got = fused_query(streams, prefix_t, n_docs=n, membership=False)
    want = fused_query_reference(streams, prefix_t, n_docs=n, membership=False)
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    check(err == 0, f"kernel != plain on the engine's streams (C={n})")
    ms = kernel_ms(lambda: fused_query(streams, prefix_t, n_docs=n, membership=False))
    plain_ms = kernel_ms(lambda: fused_query_reference(streams, prefix_t, n_docs=n, membership=False))
    setup_ms = kernel_ms(lambda: prepare_streams(
        *engine._d, mlo, mhi, plo, phi, qs, k, M=M, L=qe - qs, C=n, tile=kernel_constants(n)
    ))
    events = int(streams.off_m[-1]) + int(streams.off_p[-1])
    return {"C": n, "L": qe - qs, "M": M, "events": events, "tile": streams.tile,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "stream_setup_ms": setup_ms}


def phase_headline(device, tmp: str) -> tuple[int, dict]:
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
    res = fused.conservation("chr1", 0, L, K)
    t0 = time.perf_counter()
    format_conservation(res)
    format_ms = (time.perf_counter() - t0) * 1e3
    emit("phase3_headline", intervals=store.num_intervals, n_docs=store.n_docs, L=L, k=K,
         store_build_s=build_s, cli_query_s=cli_s, launches=launches, exact_cli_bytes=True,
         reference_loop_s=ref_s, mbp_s=mbp_s, k_sweep_exact=[21, 51, 101],
         layers_ms={"host_ranges_prefix": host_ms, "stream_setup": kern["stream_setup_ms"],
                    "kernel": kern["ms"], "format_output": format_ms},
         kernel=kern)
    return launches, kern


def phase_hprc(device) -> dict:
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
    return kern


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
    with tempfile.TemporaryDirectory() as tmp:
        launches, head = phase_headline(device, tmp)
    hprc = phase_hprc(device)
    phase_membership(device)
    print(json.dumps({"kernels": [{
        "name": "fused_query",
        "route": "cuda",
        "source": "memo_tpu_torch/csrc/fused_query.cu",
        "replaces": "memo_tpu/ops/pallas_query.py:236",
        "launches": launches,
        "max_abs_err": max(max_err, head["max_abs_err"], hprc["max_abs_err"]),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
