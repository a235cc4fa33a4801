"""Smoke run of memo_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA device
    python3 chip_smoke.py --setup-cells DIR   # the set-up cells alone (an A/B of two trees)

Builds the CUDA kernels from ``memo_tpu_torch/csrc`` (v1 ``fused_query_rows``
and v2 ``fused_query_v2_rows``, both reading the placed store's rows, and
``window_params``, which finds their parameters on the card), holds each
against its plain PyTorch version on random stores with edge cases, one and
three windows per launch, up to 1000 columns in two column groups (the
window parameters also against the numpy searches, at every launch this
script makes), runs the twin of
``__graft_entry__.entry()`` (phase 11), and drives the query paths: the
single-window path through the CLI at the headline size (2 Mbp pivot, 16
genomes, k=31), its wall split into stages (store load, engine set-up,
query, format, write; the upload's reads or inflates and its copies beside
them), its host memory, and a check that the columns went from the .npz to
the card through the staging buffers (index/npz.py) and never through
numpy's member reader, the streamed columns == the store's (phases 3, 4
and 12: deflated, stored, the chromosome's 10.3 GB), the engine's set-up
split into stages (upload, the gate, the bucket split, the card's sorts and
gathers, sentinel padding) and
the query layout it built and keeps on the card held to the numpy build
array for array; the window over a candidate cap it exceeds, launched
whole, == the reference loop, with no copy down and no wait (so too n90's
2 Mbp window at k=51, over the 2^25 cap in bucket 32, and a chromosome
window at k=51, each also == the kernels' plain version); the device
operations of one query of each kernel counted exactly by capturing its
window-parameter step (a copy up and one kernel) and its kernel function
(three kernels for v1, one for v2) into CUDA graphs, and the whole query
listed by torch.profiler (no copy down); the batched-windows path (16 staggered 1 Mbp
windows, one launch, v1 and v2, counted the same way) through the engine
and through the CLI's ``--regions-file`` with every strategy, and through
resident set up from the saved index, its windows brought to the host in
one copy (counted) or left on the card, timed apart; the
HPRC-width store (90 genomes, ~75M intervals; set-up stages and memory,
bucket 0's card layout and window parameters == numpy, a CLI ``-r`` query
of its index split into stages), a 160-genome store and dense_small
(tools/kernel_lab.py's 256 Kbp, 90-genome store) through the stratified
engine with v2, bucket 0 timed with both kernels; a 1000-genome store
(phase 13), wider than one launch takes, through the engine with each
kernel in column groups, both modes, spot windows against the reference
loops; a membership store; and
the multi-device layer (phase 10): this script run again under ``torchrun
--nproc-per-node <device count>`` in an NCCL process group, where the dry
run, the CLI's ``--regions-file --mesh 1,<n>`` with three strategies and
the n=90 store through every strategy run and are timed beside the
in-process 1 x 1 layout (each strategy's placement and dispatch apart, and
position's and interval's diff-array ops by CUDA events); and last (phase 12) the chromosome-scale index of
SCALE_r05.json (128 Mbp x 90 haplotypes, ~430M intervals, built here by
streaming synth_ms's anchors): the window parameters of its shortest and
longest rows == numpy (eight 2 Mbp windows, windows at and past the
record's end and past 100M, k in 1/21/31/101), eight 2 Mbp windows with
each kernel (set-up stages, host RSS, set-up peak and steady device
bytes, beside the sentinel pad bytes reckoned from the bucket rows), a
query of eight position chunks equal to the batch of them, the record as
one batch of 128,000 1 kbp tiles (two window groups a launch) equal to
the windows, the reference loop and resident's whole record, a regions
file of 1,400 gene windows (log-normal lengths, an empty window and single
positions) as one ragged launch of each kernel function equal to the plain
version, resident over the whole record, set up from the saved .npz with no column
read on the host (set-up stages, host RSS it adds, peak, steady and pad
device bytes;
conservation and membership, one launch per bucket), and the CLI's ``-r``
and ``--regions-file`` (auto, resolved to resident, batched, position and
interval; host RSS, peak device bytes, and no column through numpy's
reader). Every output is checked exactly
against the reference loop below (memo_query.py's per-interval slice
writes), the port's single-window outputs, the other kernel, the kernels'
plain version or the port's numpy engine. Each function's device time is
printed at every cell beside its bound (lines v1_function, v2_function and
window_function). Each phase prints one line; the last line is ``{"ok":
true, "device": {...}}``. Any failure raises, so the script exits non-zero
and prints no result. It exits non-zero at once where no CUDA device is
available.

The stores are synthetic and made from a seed here, on the port's own index
builder; nothing of the JAX package is imported.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import signal
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import weakref
import zipfile
import zlib

import numpy as np
import torch

SEED = 12345
K = 31
N_DOCS = 16  # pangenome size incl. pivot
PIVOT_LEN = 1 << 21  # 2 Mbp pivot: the headline window
WINDOW = 1 << 19  # positions per reference-loop window
LARGE_N_DOCS = 90  # HPRC width
LARGE_PIVOT_LEN = 2 << 20
KERNEL_REPS = 20  # launches per CUDA-event timing
WALL_REPS = 10  # timed end-to-end queries (median), after one warm-up
HPRC_REPS = 5
MEMB_LEN = 200_000  # membership store pivot length
MEMB_DOCS = 16
BATCH_WINDOWS, BATCH_LEN = 16, 1 << 20
WIDE_DOCS, WIDE_LEN = 160, 1 << 19
# The wide cell (phase 13): 1000 genomes over a 256 Kbp pivot, wider than
# one launch of either kernel takes (v1 854 columns, v2 819).
C1000_DOCS, C1000_LEN, C1000_GAP = 1000, 1 << 18, 30
C1000_GROUPS = 2  # launches of either kernel a call takes at C = 1000
C1000_SPOT = 1 << 13
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
INT_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores, for int32 ALU work
OVER_CAP = 1 << 20  # a candidate cap the headline window exceeds (phase 3)
EDGE_REC_LEN = 200_000  # records of the random stores that phase 2 checks v1 on
# The device operations of one query or batch, as CUDA graph nodes. The
# window-parameter step (query/window.py): csrc/window_params.cu's kernel,
# after one copy of the window starts up where there are more than its
# parameters take by value (window_graph); then the kernel function: v1's
# three kernels (csrc/fused_query.cu), or four where a conservation launch
# splits its apply (kernels_of), or v2's one. A query copies nothing down,
# at any cap (the profiler lists every operation).
V1_KERNELS = ("rows_net_kernel", "tile_scan_kernel", "rows_apply_kernel")
V2_KERNELS = ("fused_query_v2_kernel",)
# A ragged batch (windows of their own lengths, one packed output): v1's own
# four kernels, v2's one kernel built for it.
V1_RAGGED = ("ragged_place_kernel", "ragged_net_kernel", "ragged_scan_kernel",
             "ragged_apply_kernel")
V1_SPLIT = ("event_apply_kernel", "dense_apply_kernel")  # the apply of a launch that splits
STEP_OPS = ("Memcpy HtoD", "window_params_kernel", "Memcpy DtoH")  # profiler names
CAPPED_WINDOW = 1 << 19  # a window under OVER_CAP's candidates, whose record's rows pass it
K_SWEEP = (31, 51, 101, 201)  # n90's stratified engine: 1, 2, 2 and 3 live buckets
DENSE_LEN, DENSE_DOCS = 1 << 18, 90  # dense_small: tools/kernel_lab.py's 256 Kbp, C=90 store
PROFILE_TRIES = 3
MESH_REPS = 3  # timed runs of each strategy on the mesh, after one checked run
MESH_TIMEOUT_S = 300  # the torchrun of phase 10, start to end
MESH_CHILD = "--mesh-child"  # argv[1] of the ranks phase 10 starts
SETUP_CELLS = "--setup-cells"  # argv[1]: the set-up cells alone, for an A/B of two trees
DENSE_FUNCTION = "--dense-function"  # argv[1]: dense_small's kernel functions alone, for an A/B
DENSE_ROUNDS = 10  # rounds of dense_function: one CUDA-event timing and one trace a function
# The chromosome-scale index (phase 12): SCALE_r05.json's configuration, a
# 128 Mbp pivot at HPRC width (90 haplotypes, 432,249,312 intervals there),
# from synth_ms's anchors at the gap that gives its density.
CHROM_LEN, CHROM_DOCS, CHROM_GAP = 128_000_000, 90, 1100
CHROM_INTERVALS = 432_249_312  # SCALE_r05.json "intervals"
CHROM_CHUNK = 1 << 22  # MS rows generated and extracted at a time
CHROM_WINDOWS, CHROM_WINDOW = 8, 1 << 21  # SCALE_r05's eight 2 Mbp windows
CHROM_REPS = 5
CHROM_TILE = 1000  # the record in 1 kbp tiles: 128,000 windows in one batch
# A regions file of the chromosome's genes, as the benchmark's genes_chr12
# traffic: 1,400 windows, log-normal lengths of median 14 kbp and mean 27 kbp.
GENES, GENE_MEDIAN, GENE_MEAN = 1400, 14_000, 27_000
PLAIN_SLOTS = 1 << 27  # (window, row) or (window, column, position) slots of one plain call
# A query longer than the engine's position chunk: seven full 2 Mbp chunks
# and a shorter last one, from window 3's start.
CHUNKED_CHUNKS, CHUNKED_TAIL_CUT = 8, 12_345
SPOT = 1 << 15  # spot windows checked against the reference loop


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


def walls_s(fn, device: torch.device, reps: int = WALL_REPS) -> list[float]:
    """Host-clock seconds of ``reps`` calls of ``fn``, the device
    synchronised before and after each call, after one warm-up call."""
    fn()
    sync(device)
    walls = []
    for _ in range(reps):
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        walls.append(time.perf_counter() - t0)
    return walls


def wall_median_s(fn, device: torch.device, reps: int = WALL_REPS) -> float:
    """Median of :func:`walls_s`."""
    return statistics.median(walls_s(fn, device, reps))


def spread_ms(walls: list[float]) -> dict:
    """Median, least and most of host-clock walls, in ms."""
    return {"median": statistics.median(walls) * 1e3, "min": min(walls) * 1e3,
            "max": max(walls) * 1e3, "n": len(walls)}


def bound_ms(n_bytes: int, n_ops: int) -> tuple[float, str]:
    """The least time the card could take: bytes over the memory rate or
    integer operations over the ALU rate, whichever is larger."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / INT_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()


def timed_stages(run):
    """``run()``'s result, its wall seconds and the stage timers
    (``utils.profiling.GLOBAL_TIMES``: ``query.*`` of the CLI's ``-r`` path,
    ``engine.*`` and the placement's ``place.*``, each summed over buckets)
    that it recorded."""
    from memo_tpu_torch.utils.profiling import GLOBAL_TIMES

    GLOBAL_TIMES.times.clear()
    t0 = time.perf_counter()
    result = run()
    wall = time.perf_counter() - t0
    return result, wall, dict(GLOBAL_TIMES.times)


@contextlib.contextmanager
def numpy_array_reads(limit: int):
    """The element counts of the arrays over ``limit`` elements that numpy's
    member reader (``numpy.lib.format.read_array``, which ``np.load``
    reaches) reads inside the block."""
    real, big = np.lib.format.read_array, []

    def counted(*args, **kwargs):
        arr = real(*args, **kwargs)
        if arr.size > limit:
            big.append(int(arr.size))
        return arr

    np.lib.format.read_array = counted
    try:
        yield big
    finally:
        np.lib.format.read_array = real


@contextlib.contextmanager
def rss_peak():
    """This process's resident set before the block and its highest during
    it (sampled every 5 ms), in bytes."""
    out = {"rss_before_bytes": rss_bytes()}
    peak, stop = [out["rss_before_bytes"]], threading.Event()

    def poll():
        while not stop.wait(0.005):
            peak[0] = max(peak[0], rss_bytes())

    thread = threading.Thread(target=poll, daemon=True)
    thread.start()
    try:
        yield out
    finally:
        stop.set()
        thread.join()
        out["rss_peak_bytes"] = max(peak[0], rss_bytes())


def timed_cli(argv: list[str], limit: int):
    """``cli.main(argv)``'s exit code, wall, stage timers (as
    :func:`timed_stages`) and host side: the resident set before and its
    peak during the call, and how many arrays over ``limit`` elements (a
    store's records + 1) numpy's member reader read."""
    from memo_tpu_torch import cli

    with rss_peak() as host, numpy_array_reads(limit) as big:
        rc, wall, stages = timed_stages(lambda: cli.main(argv))
    return rc, wall, stages, host | {"numpy_large_reads": len(big)}


def check_streamed(stages: dict, host: dict, what: str) -> None:
    """The CLI ``-r`` above streamed its store's columns from the file: the
    read and copy stages ran, and numpy's reader read no large member."""
    check({"place.upload.read", "place.upload.copy"} <= set(stages)
          and host["numpy_large_reads"] == 0,
          f"{what}: columns streamed from the .npz, none through numpy's reader")


def streamed_columns_check(store, npz: str, device) -> dict:
    """The columns of ``npz`` (``store``, saved) streamed to the card by
    ``upload_columns``, column for column == the store's own columns
    uploaded from the host; the streamed upload's wall and stages."""
    from memo_tpu_torch.index.placement import upload_columns
    from memo_tpu_torch.index.store import COLUMNS, IntervalStore

    loaded = IntervalStore.load(npz)
    cols, wall, stages = timed_stages(lambda: upload_columns(loaded, device))
    check(loaded.file_columns()[1] == list(COLUMNS), "streamed upload read no column on the host")
    for name, col in zip(COLUMNS, cols):
        want = torch.from_numpy(getattr(store, name)).to(device)
        check(col.dtype == want.dtype and torch.equal(col, want),
              f"{name} streamed from {os.path.basename(npz)} == the store's")
        del want
    n_bytes = sum(c.numel() * c.element_size() for c in cols)
    return {"equal": True, "bytes": n_bytes, "s": wall, "stages": stages}


def npz_columns(npz: str) -> dict[str, tuple]:
    """Each ``.npy`` member of ``npz``: (method, the file offset of its data
    from its local header, compressed size, .npy header length, dtype,
    shape); the load probe's own parse, for any tree's package."""
    out = {}
    with open(npz, "rb") as fh, zipfile.ZipFile(fh) as zf:
        for info in zf.infolist():
            fh.seek(info.header_offset)
            name_len, extra_len = struct.unpack("<2H", fh.read(30)[26:30])
            with zf.open(info) as fp:
                version = np.lib.format.read_magic(fp)
                read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                        else np.lib.format.read_array_header_2_0)
                shape, _, dtype = read(fp)
                header = fp.tell()
            out[info.filename[:-4]] = (info.compress_type,
                                       info.header_offset + 30 + name_len + extra_len,
                                       info.compress_size, header, dtype, shape)
    return out


def load_split(npz: str, device) -> dict:
    """How numpy's load of the four columns of ``npz`` splits on this host:
    per member, ``np.load``'s seconds against reading the same bytes into
    an array at the member's data offset (stored) or reading its raw stream
    and inflating it (deflated), both equal to np.load's array; then the
    CRC-32 and int64 -> int32 narrowing rates on 256 MB of host memory and
    the pinned host-to-device copy rate (CUDA events)."""
    table = npz_columns(npz)
    out = {}
    for name in ("rec_id", "start", "end", "order"):
        method, offset, csize, header, dtype, shape = table[name]
        t0 = time.perf_counter()
        with np.load(npz) as z:
            want = z[name]
        np_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        arr = np.empty(shape, dtype)
        view = memoryview(arr.view(np.uint8))
        with open(npz, "rb", buffering=0) as fh:
            if method == zipfile.ZIP_STORED:
                done = 0
                while done < len(view):
                    done += os.preadv(fh.fileno(), [view[done:]], offset + header + done)
                cell = {"readinto_s": time.perf_counter() - t0}
            else:
                raw = os.pread(fh.fileno(), csize, offset)
                read_s = time.perf_counter() - t0
                t1 = time.perf_counter()
                data = zlib.decompressobj(-15).decompress(raw)
                inflate_s = time.perf_counter() - t1
                view[:] = memoryview(data)[header:]
                del raw, data
                cell = {"raw_read_s": read_s, "inflate_s": inflate_s,
                        "inflate_gb_s": arr.nbytes / inflate_s / 1e9, "compressed_bytes": csize}
        check(np.array_equal(arr, want), f"load probe: {name} read directly == np.load's")
        out[name] = {"method": "stored" if method == zipfile.ZIP_STORED else "deflated",
                     "bytes": arr.nbytes, "np_load_s": np_s,
                     "np_load_gb_s": arr.nbytes / np_s / 1e9} | cell
        del want, arr, view
    probe = np.random.default_rng(SEED).integers(0, 1 << 40, 32 << 20)  # 256 MB of int64
    t0 = time.perf_counter()
    zlib.crc32(probe)
    crc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    probe.astype(np.int32)
    narrow_s = time.perf_counter() - t0
    pinned = torch.from_numpy(probe).pin_memory()
    on_card = torch.empty_like(pinned, device=device)
    copy_ms = kernel_ms(lambda: on_card.copy_(pinned, non_blocking=True), reps=10)
    return {"members": out, "crc32_gb_s": probe.nbytes / crc_s / 1e9,
            "narrow_int64_gb_s": probe.nbytes / narrow_s / 1e9,
            "pinned_h2d_gb_s": probe.nbytes / copy_ms / 1e6}


_PLAIN = weakref.WeakKeyDictionary()  # engine -> (its rows on the host, their numpy layout)


def plain_of(engine):
    """The engine's placed rows copied back from the card (here, inside a
    check, and nowhere in the port) as an ``IntervalStore`` over its
    records, whose own record offsets and longest intervals must equal the
    card's, and its numpy ``QueryLayout.build``; made once per engine."""
    from memo_tpu_torch.index.store import IntervalStore, QueryLayout

    if engine not in _PLAIN:
        lay, parent = engine._layout, engine.store
        n = lay.num_rows
        start, end, order = (t[:n].cpu().numpy() for t in engine._d[:3])
        rows = IntervalStore(record_names=parent.record_names, record_lens=parent.record_lens,
                             n_docs=parent.n_docs, kind=parent.kind,
                             rec_id=np.repeat(np.arange(parent.num_records, dtype=np.int32),
                                              np.diff(lay.rec_offsets)),
                             start=start.astype(np.int64), end=end.astype(np.int64), order=order)
        check(np.array_equal(rows.rec_offsets, lay.rec_offsets)
              and np.array_equal(rows.max_interval_len, lay.longest),
              "card record offsets and longest intervals == IntervalStore's")
        t0 = time.perf_counter()
        layout = QueryLayout.build(rows)
        _PLAIN[engine] = rows, layout, time.perf_counter() - t0
    return _PLAIN[engine]


def layout_check(engine, store=None) -> dict:
    """The engine's placed rows and device layout, built on the card and
    copied back here, against the numpy ``QueryLayout.build`` of its rows
    (``store``'s, where given: they must be the engine's), array for array
    and in dtype; returns the numpy build's seconds."""
    from memo_tpu_torch.index.placement import PlacedStore

    rows, want, numpy_s = plain_of(engine)
    lay, n = engine._layout, rows.num_intervals
    if store is not None:
        check(all(np.array_equal(getattr(rows, a), getattr(store, a))
                  for a in ("rec_id", "start", "end", "order")), "the engine placed the store's rows")
    for name in ("col_offsets", "s_keys", "e_keys"):
        got, exp = getattr(lay, name).cpu().numpy(), getattr(want, name)
        check(got.dtype == exp.dtype and np.array_equal(got, exp), f"card layout {name} == numpy")
    check((lay.monotone, lay.key_stride) == (want.monotone, want.key_stride),
          "card layout monotone and key stride == numpy")
    seg = np.repeat(np.arange(len(want.col_offsets) - 1), np.diff(want.col_offsets))
    s_keys, e_keys = lay.s_keys.cpu().numpy(), lay.e_keys.cpu().numpy()
    check(np.array_equal(s_keys - seg * lay.key_stride, want.s_by_col)
          and np.array_equal(e_keys - seg * lay.key_stride, want.e_by_col),
          "card layout by-column starts and ends == numpy")
    rows = (rows.start, rows.end, rows.order, want.end_sorted, want.start_by_end,
            want.order_by_end)
    for name, t, exp, fill in zip(PlacedStore._fields, engine._d, rows, (0, 0, -1, 0, 0, -1)):
        check(t.dtype == torch.int32 and np.array_equal(t[:n].cpu().numpy(), exp.astype(np.int32))
              and bool((t[n:] == fill).all()), f"placed {name} == numpy, sentinel pads")
    return {"rows": n, "monotone": lay.monotone, "equal": True, "numpy_build_s": numpy_s}


def params_check(engine, record: str, window_sets, ks=(1, 21, 31, 101)) -> dict:
    """The device window parameters (``query/window.py``) of each set of
    windows of ``record`` (one launch's, at its longest length), at each k,
    against the numpy plain version on the engine's rows: params, prefix
    and candidate counts, exactly."""
    cases = 0
    for windows in window_sets:
        for k in ks:
            v1_inputs(engine, record, windows, k)
            cases += 1
    return {"launches": cases, "windows": sum(map(len, window_sets)) * len(ks), "k": list(ks),
            "equal": True}


# ------------------------------------------------- stores and reference loops
def build_store(rng):
    """The headline store: 2 Mbp pivot, 16 genomes, genome-like MS columns."""
    from memo_tpu_torch.index.builder import store_from_ms

    # MS columns with long-match structure: piecewise runs that decay by 1
    # (exact-match runs) interleaved with low-identity stretches.
    n_cols = N_DOCS - 1
    ms = np.zeros((PIVOT_LEN, n_cols), np.int32)
    for c in range(n_cols):
        pos = 0
        while pos < PIVOT_LEN:
            run = int(rng.integers(40, 4000))
            run = min(run, PIVOT_LEN - pos)
            if rng.random() < 0.8:  # conserved stretch: MS counts down from run
                ms[pos : pos + run, c] = np.arange(run, 0, -1)
            else:  # diverged stretch: short noisy matches
                ms[pos : pos + run, c] = rng.integers(0, K - 1, run)
            pos += run
    # Enforce the matching-statistics law ms[p] <= ms[p+1] + 1:
    # out[p] = min_{q>=p} (ms[q] + q) - p.
    idx = np.arange(PIVOT_LEN, dtype=np.int64)[:, None]
    ms = (np.minimum.accumulate((ms + idx)[::-1])[::-1] - idx).astype(np.int32)
    return store_from_ms([ms], ["chr1"], [PIVOT_LEN], N_DOCS, "conservation")


def synth_ms(rng, pivot_len: int, n_cols: int, k: int, gap: int = 15) -> np.ndarray:
    """Genome-like MS matrix, fast at HPRC width: per column, sparse match
    anchors (~1 per ``gap`` positions, value = match length 8..120) joined by
    the suffix-min transform, which enforces ms[p] <= ms[p+1] + 1 and turns
    each anchor into a descending exact-match ramp. Column blocks keep peak
    memory at O(P) int32 whatever the width."""
    out = np.empty((pivot_len, n_cols), np.int32)
    idx = np.arange(pivot_len, dtype=np.int32)
    n_anchor = max(pivot_len // gap, 1)
    for c0 in range(0, n_cols, 8):
        c1 = min(c0 + 8, n_cols)
        blk = np.full((pivot_len, c1 - c0), 1 << 28, np.int32)
        for j in range(c1 - c0):
            pos = rng.choice(pivot_len, n_anchor, replace=False)
            blk[pos, j] = rng.integers(8, 120, n_anchor).astype(np.int32)
        blk += idx[:, None]
        np.minimum.accumulate(blk[::-1], axis=0, out=blk[::-1])
        blk -= idx[:, None]
        np.minimum(blk, (pivot_len - idx)[:, None], out=blk)
        out[:, c0:c1] = blk
    return out


def build_large_store(rng):
    """The HPRC-width store: 90 haplotypes over a 2 Mbp pivot."""
    from memo_tpu_torch.index.builder import store_from_ms

    ms = synth_ms(rng, LARGE_PIVOT_LEN, LARGE_N_DOCS - 1, K, gap=25)
    return store_from_ms([ms], ["chr1"], [LARGE_PIVOT_LEN], LARGE_N_DOCS, "conservation")


def build_chromosome_store(rng, length: int = CHROM_LEN, n_docs: int = CHROM_DOCS,
                           gap: int = CHROM_GAP, device="cuda", chunk: int = CHROM_CHUNK):
    """The chromosome-scale store: ``store_from_ms([synth_ms(rng, length,
    n_docs - 1, K, gap)])``, equal to it row for row, without the MS matrix
    (128M x 89 int32 is 45.6 GB). Each column keeps synth_ms's anchors, drawn
    in its order; a row chunk's MS is, per column, the suffix minimum of
    (value + position) over the anchors at or right of each position, less
    the position, capped at the record's end. The chunks are computed on
    ``device``, their rows sorted there (the conservation store's order
    MEMs), and streamed in order through the port's
    ``StreamingOverlapExtractor``, as ``builder.store_from_doc_columns``
    feeds it; the next chunk is computed while the host extracts one."""
    from memo_tpu_torch.index.intervals import StreamingOverlapExtractor
    from memo_tpu_torch.index.store import IntervalStore

    device = torch.device(device)
    n_cols = n_docs - 1
    n_anchor = max(length // gap, 1)
    pos = np.empty((n_cols, n_anchor), np.int32)
    top = np.empty((n_cols, n_anchor + 1), np.int32)  # value + position; a sentinel last
    top[:, -1] = 1 << 30
    for c in range(n_cols):  # synth_ms's draws, column by column
        p = rng.choice(length, n_anchor, replace=False)
        v = rng.integers(8, 120, n_anchor)
        order = np.argsort(p)
        pos[c], top[c, :-1] = p[order], p[order] + v[order]
    pos_t = torch.from_numpy(pos).to(device)
    suffix_min = torch.from_numpy(top).to(device).flip(1).cummin(1).values.flip(1).contiguous()
    del pos, top
    pinned = device.type == "cuda"
    bufs = [torch.empty((chunk, n_cols), dtype=torch.int32, pin_memory=pinned) for _ in range(2)]

    def launch(i: int):
        """Chunk i's rows, sorted descending, into its host buffer."""
        lo = i * chunk
        p = torch.arange(lo, min(lo + chunk, length), dtype=torch.int32, device=device)
        nxt = torch.searchsorted(pos_t, p.expand(n_cols, -1).contiguous(), out_int32=True)
        ms = torch.minimum(suffix_min.gather(1, nxt.long()) - p, length - p)
        rows = ms.t().sort(dim=1, descending=True).values
        buf = bufs[i % 2][: p.numel()]
        buf.copy_(rows, non_blocking=pinned)
        done = torch.cuda.Event() if pinned else None
        if pinned:
            done.record()
        return buf, done

    extractor = StreamingOverlapExtractor(n_cols, length, order_sort=False)  # rows come sorted
    parts = []
    n_chunks = -(-length // chunk)
    pending = launch(0)
    for i in range(n_chunks):
        buf, done = pending
        if i + 1 < n_chunks:
            pending = launch(i + 1)
        if done is not None:
            done.synchronize()
        s, e, o = extractor.feed(buf.numpy())
        parts.append((s, e, o.astype(np.int32)))
    s, e, o = extractor.finish()
    parts.append((s, e, o.astype(np.int32)))
    del bufs, pos_t, suffix_min
    starts, ends, orders = (np.concatenate(col) for col in zip(*parts))
    del parts
    return IntervalStore(record_names=["chr1"], record_lens=[length], n_docs=n_docs,
                         kind="conservation", rec_id=np.zeros(starts.size, np.int32),
                         start=starts, end=ends, order=orders)


def reference_membership_np(store, qs: int, qe: int, k: int) -> np.ndarray:
    """The reference membership path (memo_query.py:50-51,57-68): a ones
    matrix and per-interval slice writes of False."""
    lo, hi = store.window_bounds("chr1", qs, qe, k)
    L = qe - qs
    n = store.n_docs
    starts = np.clip(store.start[lo:hi] - qs, 0, L)
    ends = np.clip(store.end[lo:hi] - qs - (k - 1), 0, L)
    orders = store.order[lo:hi]
    keep = ends < starts
    starts, ends, orders = starts[keep], ends[keep], orders[keep]
    rec = np.ones((L, n), bool)
    for s, ce, o in zip(starts, ends, orders):
        rec[ce:s, o] = False
    return rec.astype(np.int8)


def reference_query_np(store, qs: int, qe: int, k: int) -> np.ndarray:
    """The reference query path (memo_query.py:42-71) on this window:
    recenter/shadow-cast/clip, per-interval slice writes, argmax."""
    lo, hi = store.window_bounds("chr1", qs, qe, k)
    L = qe - qs
    n = store.n_docs
    starts = store.start[lo:hi] - qs
    ends = store.end[lo:hi] - qs - (k - 1)
    orders = store.order[lo:hi]
    starts = np.clip(starts, 0, L)
    ends = np.clip(ends, 0, L)
    keep = ends < starts
    starts, ends, orders = starts[keep], ends[keep], orders[keep]
    rec = np.zeros((L, n + 1), bool)
    rec[:, n] = True
    for s, ce, o in zip(starts, ends, orders):
        rec[ce:s, o] = True
    return np.argmax(rec, axis=1)


def random_store(rng, C: int, kind: str, rec_len: int, per_pos: int = 3):
    """Random intervals on chr0 and chr1 (chr2 has none): most short enough
    to mark at k=31, ends up to 2x past the record, 5% of orders -1 and 5%
    >= C (rows the kernel must drop)."""
    from memo_tpu_torch.index.store import IntervalStore

    rows = []
    for r, n in ((0, rec_len * per_pos), (1, rec_len * per_pos), (2, 0)):
        start = rng.integers(0, rec_len, n)
        span = np.where(rng.random(n) < 0.7, rng.integers(0, 40, n), rng.integers(40, rec_len, n))
        order = rng.integers(0, C, n)
        bad = rng.random(n)
        order[bad < 0.05] = -1
        order[bad > 0.95] = C + rng.integers(0, 3, int((bad > 0.95).sum()))
        rows.append((np.full(n, r), start, start + span, order))
    rec, start, end, order = (np.concatenate(c) for c in zip(*rows))
    keep = np.lexsort((end, start, rec))
    return IntervalStore(record_names=["chr0", "chr1", "chr2"], record_lens=[rec_len] * 3,
                         n_docs=C, kind=kind, rec_id=rec[keep], start=start[keep],
                         end=end[keep], order=order[keep])


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
    from memo_tpu_torch.native.build import build_error, load_libms
    from memo_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.build_library()
    seconds = time.perf_counter() - t0
    _build.load_library()
    t0 = time.perf_counter()
    check(load_libms() is not None, f"libms (the index builder's MS library) built: {build_error()}")
    libms_s = time.perf_counter() - t0
    log = (lib.parent / "build.log").read_text() if (lib.parent / "build.log").exists() else ""
    ptxas = [ln.strip() for ln in log.splitlines()
             if any(word in ln for word in ("registers", "Compiling entry", "spill"))]
    emit("phase1_build", seconds=seconds, libms_seconds=libms_s, library=os.path.relpath(lib),
         ptxas=ptxas)


def phase_entry(device) -> None:
    """The twin of ``__graft_entry__.entry()`` once on the card, against the
    numpy engine's ops on the same arguments."""
    from memo_tpu_torch.entry import entry
    from memo_tpu_torch.ops.query_ops import conservation_np, coverage_marks_np

    fn, args = entry(device)
    out = fn(*args)
    sync(device)
    starts, ends, orders = (a.cpu().numpy() for a in args[:3])
    want = conservation_np(coverage_marks_np(starts, ends, orders, 0, 31, 1024, 8), 8)
    check(out.device.type == "cuda" and out.dtype == torch.int32 and tuple(out.shape) == (1024,),
          f"entry() output on the card, int32[1024]: {out.device} {out.dtype} {tuple(out.shape)}")
    check(np.array_equal(out.cpu().numpy(), want), "entry() == numpy conservation")
    emit("phase11_entry", shape=list(out.shape), dtype=str(out.dtype), exact_vs_numpy=True)


WINDOW_CHECKS = {"cases": 0, "windows": 0, "max_abs_err": 0}  # the window kernel against its plain version


def v1_inputs(engine, record: str, windows, k: int):
    """The parameters int32[Q, 5] (mlo, mhi, plo, phi, qs), the prefix
    int32[Q, C] and the candidate counts [2, Q] of ``windows``, found on the
    card by the window kernel as the engine finds them (every window at the
    longest length L, as conservation_batch runs them), checked exactly
    against its plain version on the same tensors and against the numpy
    searches on the engine's rows; and L."""
    from memo_tpu_torch.query.window import window_params_numpy, window_params_reference

    L = max(qe - qs for qs, qe in windows)
    starts = [qs for qs, _ in windows]
    wp = engine._window_params(record, starts, L, k)
    r = engine.store.record_index(record)
    plain = window_params_reference(engine._d, engine._layout, r, starts, L, k)
    err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) for a, b in zip(wp, plain))
    WINDOW_CHECKS["cases"] += 1
    WINDOW_CHECKS["windows"] += len(windows)
    WINDOW_CHECKS["max_abs_err"] = max(WINDOW_CHECKS["max_abs_err"], err)
    where = f"window parameters C={engine.n_docs} k={k} {record} L={L} {windows[:3]}"
    check(err == 0, f"{where}: the window kernel != its plain version")
    rows, layout, _ = plain_of(engine)
    params, prefix = window_params_numpy(rows, layout, r, starts, L, k)
    check(wp.params.dtype == wp.prefix.dtype == torch.int32, f"{where}: int32")
    check(np.array_equal(wp.params.cpu().numpy(), params), f"{where}: params == numpy")
    check(np.array_equal(wp.prefix.cpu().numpy(), prefix), f"{where}: prefix == numpy")
    check(np.array_equal(wp.counts.cpu().numpy(), np.stack([params[:, 1] - params[:, 0],
                                                             params[:, 3] - params[:, 2]])),
          f"{where}: counts == numpy")
    return wp, L


def kernel_case(engine, record, windows, k, membership, kernels) -> dict[str, int]:
    """Each of ``kernels`` (name -> a function with fused_query_rows'
    signature) against the plain version on the same device tensors; returns
    each one's error (it must be 0)."""
    from memo_tpu_torch.ops.fused_query import fused_query_rows_reference

    wp, L = v1_inputs(engine, record, windows, k)
    args = wp.params, wp.prefix
    C = engine.n_docs
    want = fused_query_rows_reference(engine._d, *args, k=k, L=L, C=C, n_docs=C,
                                      membership=membership)
    errors = {}
    for name, fn in kernels.items():
        got = fn(engine._d, *args, k=k, L=L, C=C, n_docs=C, membership=membership)
        torch.cuda.synchronize()
        where = f"{name} C={C} k={k} {record} {windows} membership={membership}"
        check(got.dtype == want.dtype and got.shape == want.shape, f"{where} shape/dtype")
        errors[name] = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        check(errors[name] == 0, f"kernel != plain: {where}")
    return errors


def kernel_functions() -> dict:
    """The kernel wrappers: v1 and v2."""
    from memo_tpu_torch.ops.fused_query import fused_query_rows
    from memo_tpu_torch.ops.fused_query_v2 import fused_query_v2_rows

    return {"v1": fused_query_rows, "v2": fused_query_v2_rows}


def phase_kernels(device) -> dict[str, int]:
    """Both kernels (v1 fused_query_rows, v2 fused_query_v2_rows) against
    fused_query_rows_reference over all columns, on random stores at
    C = 16/90/160 (256-position tiles), 257 (128) and 1000 (the wrapper
    launches two column groups of 500, 64-position tiles; the launches of
    each call counted): k in {1, 2, 31}, one window at a
    record's start, at its end (the rows after it are the next record's),
    of one position, of an empty record and of a whole 200 Kbp record, and
    three windows per launch at the longest length (one runs past the
    record's end); both kinds. Prints one line for v1 (phase 2) and one for
    v2 (phase 6)."""
    from memo_tpu_torch.query.engine import QueryEngine

    rng = np.random.default_rng(SEED)
    rec_len = EDGE_REC_LEN
    singles = (("chr0", [(0, 4096 + 17)]), ("chr0", [(rec_len - 777, rec_len)]),
               ("chr1", [(5555, 5556)]), ("chr2", [(0, 1000)]), ("chr1", [(0, rec_len)]))
    batch = ("chr0", [(0, 3000), (rec_len - 1000, rec_len), (77_777, 77_778)])
    widths = (16, 90, 160, 257, 1000)
    kernels = kernel_functions()
    errors = {name: [] for name in kernels}
    groups = {name: [] for name in kernels}
    for C in widths:
        before = {name: fn.launches for name, fn in kernels.items()}
        for kind in ("conservation", "membership"):
            eng = QueryEngine(random_store(rng, C, kind, rec_len), device=device, stratify=False)
            for k in (1, 2, 31):
                for record, wins in (*singles, batch):
                    for name, err in kernel_case(eng, record, wins, k, kind == "membership",
                                                 kernels).items():
                        errors[name].append(err)
            del eng
        calls = 2 * 3 * (len(singles) + 1)
        for name, fn in kernels.items():
            launched = fn.launches - before[name]
            want = (C1000_GROUPS if C == C1000_DOCS else 1) * calls
            check(launched == want, f"{name} C={C}: {launched} launches, want {want}")
            groups[name].append(launched // calls)
    worst = {name: max(errs) for name, errs in errors.items()}
    for phase, name in (("phase2_kernels", "v1"), ("phase6_kernels_v2", "v2")):
        emit(phase, cases=len(errors[name]), max_abs_err=worst[name], widths=list(widths),
             column_groups=groups[name], k=[1, 2, 31], windows_per_launch=[1, 3])
    return worst


def time_function(engine, record: str, windows, k: int, version: str = "v1") -> dict:
    """The v1 (fused_query_rows) or v2 (fused_query_v2_rows) function on
    ``windows``, from the parameters found on the card: exact against its
    plain version; device times of it, of its plain version and of the
    window-parameter step, and of its kernels (profiler). Its bound from this
    input's row counts: 12 bytes a candidate row, read once, plus the
    output."""
    from memo_tpu_torch.ops.fused_query import fused_query_rows_reference, rows_tile
    from memo_tpu_torch.ops.fused_query_v2 import v2_constants

    fn = kernel_functions()[version]
    wp, L = v1_inputs(engine, record, windows, k)
    args = wp.params, wp.prefix
    C = engine.n_docs
    n_win = len(windows)
    err = kernel_case(engine, record, windows, k, False, {version: fn})[version]

    def run():
        return fn(engine._d, *args, k=k, L=L, C=C, n_docs=C, membership=False)

    ms = kernel_ms(run)
    plain = kernel_ms(lambda: fused_query_rows_reference(engine._d, *args, k=k, L=L, C=C,
                                                         n_docs=C, membership=False), reps=5)
    starts = [qs for qs, _ in windows]
    step = kernel_ms(lambda: engine._window_params(record, starts, L, k))
    rows = int(wp.counts.sum())
    n_bytes = rows * 12 + n_win * L * 4 + wp.params.numel() * 4 + wp.prefix.numel() * 4
    n_ops = n_win * L * C + rows  # one scan add per (position, column), one atomic per row
    bound, bound_by = bound_ms(n_bytes, n_ops)
    ops = device_ops(run, kernels_of(version, C, n_win, L))  # the kernels alone
    return {"version": version, "C": C, "L": L, "windows": n_win, "candidate_rows": rows,
            "tile": rows_tile(C) if version == "v1" else v2_constants(C)[0],
            "max_abs_err": err, "ms": ms, "plain_ms": plain, "window_params_ms": step,
            "bytes": n_bytes, "ops": n_ops, "bound_ms": bound, "bound_by": bound_by,
            "bound_share": bound / ms, "kernels_us": ops}


def time_window_params(engine, record: str, windows, k: int) -> dict:
    """The window kernel (csrc/window_params.cu) on ``windows``, one
    launch's: exact against its plain version (:func:`v1_inputs`); device
    times of the wrapper (the copy of the starts and the kernel) and of its
    plain version by CUDA events over back-to-back calls, of the kernel
    alone by the profiler; and three walls, each with what the query must
    have on the host before it launches: the step with the read of its
    counts, its plain version (torch operations) with the same read, and
    the numpy search on the host with one copy of its output up
    (:func:`host_search_upload`).
    Its bound: what the searches must read (log2 of the rows or keys
    searched: 4 bytes a row, 8 a key; a scan reads the record's rows once)
    and the output, against the memory rate; a comparison a word read."""
    from memo_tpu_torch.query.window import window_params_reference

    v1_inputs(engine, record, windows, k)
    lay, r = engine._layout, engine.store.record_index(record)
    L = max(qe - qs for qs, qe in windows)
    starts = [qs for qs, _ in windows]

    def step():
        return engine._window_params(record, starts, L, k)

    ms = kernel_ms(step)
    plain = kernel_ms(lambda: window_params_reference(engine._d, lay, r, starts, L, k))
    ops = device_ops(step, ("Memcpy HtoD", "window_params_kernel"),
                     sum(window_graph(len(windows)).values()))
    # None where the profiler's traces all missed the kernel: not measured.
    kernel_us = next((us for name, us in ops if "window_params_kernel" in name), None)
    wall = spread_ms(walls_s(lambda: step().counts.tolist(), engine.device))
    plain_wall = spread_ms(walls_s(
        lambda: window_params_reference(engine._d, lay, r, starts, L, k).counts.tolist(),
        engine.device))
    host_wall = spread_ms(walls_s(lambda: host_search_upload(engine, record, starts, L, k),
                                  engine.device))
    n_win, C = len(windows), engine.n_docs
    rec_rows = int(lay.rec_offsets[r + 1] - lay.rec_offsets[r])
    depth_rows, depth_keys = rec_rows.bit_length() or 1, lay.s_keys.numel().bit_length() or 1
    words = 4 * depth_rows * 4
    words += 2 * (C - 1) * depth_keys * 8 if lay.monotone else rec_rows * 12
    n_bytes = n_win * (words + 8 + (7 + C) * 4)
    n_ops = n_win * (4 * depth_rows + (2 * (C - 1) * depth_keys if lay.monotone else rec_rows))
    bound, bound_by = bound_ms(n_bytes, n_ops)
    return {"windows": n_win, "C": C, "record_rows": rec_rows, "monotone": lay.monotone,
            "ms": ms, "plain_ms": plain, "kernel_us": kernel_us,
            "device_op_list": ops, "wall_with_count_read_ms": wall,
            "plain_wall_with_count_read_ms": plain_wall, "host_search_wall_ms": host_wall,
            "bytes": n_bytes, "ops": n_ops,
            "bound_ms": bound, "bound_by": bound_by, "bound_share": bound / ms}


def host_search_upload(engine, record: str, starts, L: int, k: int) -> torch.Tensor:
    """The window step as the engine ran it while it kept its rows on the
    host: the numpy searches over the rows and their ``QueryLayout``
    (:func:`plain_of`'s, here), params and prefix packed into one pinned
    int32 buffer and copied up in one copy, without waiting on it."""
    from memo_tpu_torch.query.window import window_params_numpy

    rows, layout, _ = plain_of(engine)
    params, prefix = window_params_numpy(rows, layout, engine.store.record_index(record), starts,
                                         L, k)
    host = torch.empty(params.size + prefix.size, dtype=torch.int32, pin_memory=True)
    view = host.numpy()
    view[: params.size] = params.ravel()
    view[params.size :] = prefix.ravel()
    return host.to(engine.device, non_blocking=True)


def kernels_of(version: str, C: int, n_win: int, L: int, total: int | None = None) -> tuple:
    """The kernels of one conservation launch of ``version``'s function over
    ``n_win`` windows of ``L`` positions, or of a ragged batch of ``total``
    positions: v2's one; v1's three (four ragged), the last of them the
    event and the dense apply where the launch splits its tiles on this card
    (``fused_query.event_rows``)."""
    if version != "v1":
        return V2_KERNELS
    from memo_tpu_torch.ops.fused_query import MAX_COLUMNS, event_rows, ragged_units, rows_tile

    G = -(-C // -(-C // MAX_COLUMNS))
    T = rows_tile(G)
    kernels, tiles = ((V1_KERNELS, n_win * -(-L // T)) if total is None
                      else (V1_RAGGED, ragged_units(total, n_win, T)))
    return kernels[:-1] + V1_SPLIT if event_rows(G, tiles, total is not None) else kernels


def device_ops(fn, expect: tuple[str, ...], count: int | None = None) -> list[tuple[str, float]]:
    """The device operations (kernels, copies, memsets) of one call of
    ``fn``, with their device microseconds, from torch.profiler, in the
    order they ran. Every name must hold one of ``expect``; a trace of
    other than ``count`` operations (one of each of ``expect`` by default)
    is taken again (the profiler has been seen to drop a kernel on that
    machine), up to PROFILE_TRIES times, and the last is returned. The
    counts that decide are :func:`graph_ops`'."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.01)  # keep the first operation clear of the trace's start
            fn()
            torch.cuda.synchronize()
        ops = sorted(((evt.time_range.start, evt.name, evt.time_range.end - evt.time_range.start)
                      for evt in prof.events() if str(evt.device_type).endswith("CUDA")))
        ops = [(name, us) for _, name, us in ops]
        check(all(any(e in name for e in expect) for name, _ in ops),
              f"only {expect} on the device, got {ops}")
        if len(ops) == (len(expect) if count is None else count):
            break
    return ops


GRAPH_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty",
                    6: "event_wait", 7: "event_record", 10: "mem_alloc", 11: "mem_free"}


def graph_ops(fn) -> dict[str, int]:
    """The device operations of one call of ``fn``, counted exactly: the call
    is captured into a CUDA graph (relaxed mode, on a side stream, after a
    warm-up call there) and the graph's nodes are counted by type. Nothing
    is replayed."""
    import ctypes

    try:
        rt = ctypes.CDLL("libcudart.so.12")
    except OSError:
        rt = ctypes.CDLL("/usr/local/cuda/lib64/libcudart.so")
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(rt.cudaGraphGetNodes(raw, None, ctypes.byref(n)) == 0, "cudaGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(rt.cudaGraphGetNodes(raw, nodes, ctypes.byref(n)) == 0, "cudaGraphGetNodes")
    counts: dict[str, int] = {}
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(rt.cudaGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0,
              "cudaGraphNodeGetType")
        name = GRAPH_NODE_TYPES.get(kind.value, str(kind.value))
        counts[name] = counts.get(name, 0) + 1
    graph.reset()
    torch.cuda.synchronize()
    return counts


def window_graph(n_win: int) -> dict[str, int]:
    """The window step's device operations for ``n_win`` windows: its
    kernel, after one copy of the starts up where they do not all go by
    value in its parameters."""
    from memo_tpu_torch.query.window import inline_starts

    return {"kernel": 1} if n_win <= inline_starts() else {"memcpy": 1, "kernel": 1}


def copies_of(ops) -> list[int]:
    """The copies up and down in a profiler list of device operations."""
    return [sum(kind in name for name, _ in ops) for kind in ("Memcpy HtoD", "Memcpy DtoH")]


def query_graphs(engine, record: str, windows, k: int) -> dict:
    """The device operations of one query of ``windows`` (one launch): the
    window-parameter step and the kernel function each captured into a CUDA
    graph and counted by node type (exactly), and the whole query listed by
    torch.profiler: the step, the function and nothing else, no copy
    down."""
    L = max(qe - qs for qs, qe in windows)
    kernels = kernels_of(engine.kernel_version, engine.n_docs, len(windows), L)
    want_fn = {"kernel": len(kernels)}
    starts = [qs for qs, _ in windows]
    step = graph_ops(lambda: engine._window_params(record, starts, L, k))
    want_step = window_graph(len(windows))
    check(step == want_step, f"the window-parameter step of {len(windows)} window(s) is "
                             f"{want_step}: {step}")
    wp = engine._window_params(record, starts, L, k)
    fn = kernel_functions()[engine.kernel_version]
    C = engine.n_docs
    function = graph_ops(lambda: fn(engine._d, wp.params, wp.prefix, k=k, L=L, C=C, n_docs=C,
                                    membership=False))
    check(function == want_fn, f"the {engine.kernel_version} function is {want_fn}: {function}")
    query = ((lambda: engine.conservation(record, *windows[0], k)) if len(windows) == 1
             else (lambda: engine.conservation_batch(record, windows, k)))
    n_ops = sum(step.values()) + len(kernels)
    ops = device_ops(query, STEP_OPS + kernels, n_ops)
    copies = copies_of(ops)
    check(copies == [step.get("memcpy", 0), 0],
          f"{step.get('memcpy', 0)} copy up and none down a query: {copies} in {ops}")
    return {"step_graph": step, "function_graph": function, "device_ops": n_ops,
            "device_op_list": ops}


def capped_query_ops(capped, record: str, window: tuple[int, int], k: int) -> dict:
    """One query of ``window`` through ``capped``, an engine whose cap the
    record's rows pass (and, at the headline, the window's candidates): the
    profiler's device operations are the step and the kernel function,
    exactly, with no copy down: nothing is read whatever the cap."""
    kernels = kernels_of(capped.kernel_version, capped.n_docs, 1, window[1] - window[0])
    rows = int(np.diff(capped._layout.rec_offsets)[capped.store.record_index(record)])
    check(rows > capped.max_intervals, f"{record}'s rows pass the capped engine's cap")
    wp = capped._window_params(record, [window[0]], window[1] - window[0], k)
    count = int(wp.counts.max())
    n_ops = sum(window_graph(1).values()) + len(kernels)
    ops = device_ops(lambda: capped.conservation(record, *window, k), STEP_OPS + kernels, n_ops)
    copies = copies_of(ops)
    check(copies == [0, 0] and len(ops) == n_ops,
          f"no copy up or down a query over a cap its record's rows pass: {copies} in {ops}")
    return {"window": list(window), "candidates": count, "cap": capped.max_intervals,
            "record_rows": rows, "device_ops": n_ops, "count_copies_down": copies[1],
            "device_op_list": ops}


def plain_window(engine, record: str, qs: int, qe: int, k: int) -> torch.Tensor:
    """The conservation of [qs, qe) from the kernels' plain version
    (``fused_query_rows_reference``) in each of ``engine``'s engines that
    can mark at k, min-combined, on the card."""
    from memo_tpu_torch.ops.fused_query import fused_query_rows_reference

    engines = ([c for lb, c in engine._children if lb < k - 1] if engine._children is not None
               else [engine])
    out, C = None, engine.n_docs
    for child in engines:
        wp = child._window_params(record, [qs], qe - qs, k)
        one = fused_query_rows_reference(child._d, wp.params, wp.prefix, k=k, L=qe - qs, C=C,
                                         n_docs=C, membership=False)[0]
        out = one if out is None else torch.minimum(out, one)
    return out


def no_wait_query(engine, record: str, qs: int, qe: int, k: int, plain: bool = False) -> dict:
    """One query of [qs, qe) at k through ``engine`` (output left on the
    card) with ``torch.cuda.set_sync_debug_mode("error")``, so that any
    operation that waits on the card raises, and with
    ``torch.cuda.Event.synchronize`` and ``torch.cuda.synchronize`` counting
    their calls: it must make none, at any cap; its output equals the same
    query's run normally (and, with ``plain``, the plain version's,
    :func:`plain_window`). The same query under torch.profiler copies
    nothing down. Reports the live buckets' candidates and whether any
    passes its cap; ``last_stats`` is read after it."""
    calls = []
    real_event, real_sync = torch.cuda.Event.synchronize, torch.cuda.synchronize

    def event_sync(self):
        calls.append("Event.synchronize")
        return real_event(self)

    def device_sync(*args, **kwargs):
        calls.append("torch.cuda.synchronize")
        return real_sync(*args, **kwargs)

    want = engine.conservation(record, qs, qe, k)
    real_sync()
    torch.cuda.Event.synchronize, torch.cuda.synchronize = event_sync, device_sync
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = engine.conservation(record, qs, qe, k)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.Event.synchronize, torch.cuda.synchronize = real_event, real_sync
    check(not calls, f"a query waited: {calls}")
    check(torch.equal(got, want), "the no-wait query's output == the query's")
    live = ([(lb, c) for lb, c in engine._children if lb < k - 1] if engine._children is not None
            else [(0, engine)])
    kernels = kernels_of(engine.kernel_version, engine.n_docs, 1, qe - qs)
    # Each live bucket's step and kernels, and the buckets' minimum.
    ops = device_ops(lambda: engine.conservation(record, qs, qe, k),
                     STEP_OPS + kernels + ("elementwise_kernel",),
                     len(live) * (1 + len(kernels)) + len(live) - 1)
    copies = copies_of(ops)
    check(copies[1] == 0, f"a query copied nothing down: {copies} in {ops}")
    candidates = {lb: int(c._window_params(record, [qs], qe - qs, k).counts.max())
                  for lb, c in live}
    out = {"window": [qs, qe], "k": k, "waits": len(calls), "count_copies_down": copies[1],
           "equal": True, "candidates_by_bucket": candidates,
           "over_cap": any(candidates[lb] > c.max_intervals for lb, c in live),
           "last_stats": engine.last_stats.as_dict()}
    if plain:
        check(torch.equal(got, plain_window(engine, record, qs, qe, k)),
              f"the query of {qs}-{qe} at k={k} == the plain version")
        out["plain_equal"] = True
    return out


def phase_headline(device, tmp: str):
    from memo_tpu_torch import cli
    from memo_tpu_torch.ops.fused_query import fused_query_rows
    from memo_tpu_torch.query.engine import QueryEngine
    from memo_tpu_torch.query.output import format_conservation
    from memo_tpu_torch.query.window import window_params

    L = PIVOT_LEN
    t0 = time.perf_counter()
    store = build_store(np.random.default_rng(SEED))
    build_s = time.perf_counter() - t0
    npz = os.path.join(tmp, "headline.npz")
    out = os.path.join(tmp, "cons.txt")
    store.save(npz)

    fused_query_rows.launches = window_params.launches = 0
    rc, cli_s, cli_stages, cli_host = timed_cli(
        ["query", "-b", npz, "-k", str(K), "-r", f"chr1:0-{L}", "-o", out,
         "--device", device.type, "--stats"], store.num_records + 1)
    launches = {"v1": fused_query_rows.launches, "window": window_params.launches}
    check(rc == 0, "CLI query exit code")
    check_streamed(cli_stages, cli_host, "headline CLI -r (deflated .npz)")
    check(launches["v1"] > 0 and launches["window"] > 0,
          f"the CLI query launched the window and v1 kernels: {launches}")

    windows = [(w, min(w + WINDOW, L)) for w in range(0, L, WINDOW)]
    t0 = time.perf_counter()
    ref = np.concatenate([reference_query_np(store, qs, qe, K) for qs, qe in windows])
    ref_s = time.perf_counter() - t0
    with open(out, "rb") as fh:
        got_bytes = fh.read()
    check(got_bytes == format_conservation(ref), "CLI output bytes == reference loop")
    streamed = streamed_columns_check(store, npz, device)

    mbp_s = {}
    for backend in ("fused", "torch"):
        eng = QueryEngine(store, backend=backend, device=device, chunk_positions=L,
                          device_output=True)
        dt = wall_median_s(lambda: eng.conservation("chr1", 0, L, K), device)
        mbp_s[backend] = L / dt / 1e6

    torch.cuda.reset_peak_memory_stats()
    fused, init_s, init_stages = timed_stages(
        lambda: QueryEngine(store, backend="fused", device=device, chunk_positions=L))
    setup_peak = torch.cuda.max_memory_allocated()
    steady = torch.cuda.memory_allocated()
    layout = layout_check(fused, store)
    wins = batch_windows(PIVOT_LEN)
    # The most window starts that go by value, and one more (copied up).
    from memo_tpu_torch.query.window import inline_starts

    edge = [[(int(qs), int(qs) + 1000) for qs in np.linspace(0, PIVOT_LEN - 1000, n)]
            for n in (inline_starts(), inline_starts() + 1)]
    params = params_check(fused, "chr1", [[(0, L)], wins] + [[w] for w in wins] + edge)
    oracle = QueryEngine(store, backend="numpy", device="cpu")
    for k in (21, 51, 101):
        check(np.array_equal(fused.conservation("chr1", 0, L, k), oracle.conservation("chr1", 0, L, k)),
              f"fused == numpy engine at k={k}")
    # Over the cap: the window is launched once, whole; its stats replay
    # memo_tpu's halving when read.
    capped = QueryEngine(store, backend="fused", device=device, chunk_positions=L,
                         max_intervals_per_chunk=OVER_CAP, device_output=True)
    check(np.array_equal(capped.conservation("chr1", 0, L, K).cpu().numpy(), ref)
          and capped.last_stats.candidate_intervals > OVER_CAP,
          f"a window over a cap of {OVER_CAP} candidates, launched whole == reference loop")
    over_cap = capped.last_stats.as_dict()
    capped_ops = {"under": capped_query_ops(capped, "chr1", (0, CAPPED_WINDOW), K),
                  "over": capped_query_ops(capped, "chr1", (0, L), K)}
    check(capped_ops["over"]["candidates"] > OVER_CAP, "the whole window passes the cap")
    capped_no_wait = no_wait_query(capped, "chr1", 0, L, K)
    check(capped_no_wait["over_cap"], "the capped no-wait window is over the cap")
    del capped

    # The device operations of one headline query (result left on the device),
    # its wall, and that it waits on nothing.
    resident = QueryEngine(store, backend="fused", device=device, chunk_positions=L,
                           device_output=True)
    ops = query_graphs(resident, "chr1", [(0, L)], K)
    no_wait = no_wait_query(resident, "chr1", 0, L, K)
    query_wall = spread_ms(walls_s(lambda: resident.conservation("chr1", 0, L, K), device))
    resident_v2 = QueryEngine(store, backend="fused", device=device, chunk_positions=L,
                              device_output=True, kernel_version="v2")
    ops_v2 = query_graphs(resident_v2, "chr1", [(0, L)], K)
    del resident_v2

    # Layer breakdown of one query: the window-parameter step (device time,
    # and wall with the read of its counts), the v1 function (device time),
    # formatting.
    window_fn = time_window_params(fused, "chr1", [(0, L)], K)
    kern = time_function(fused, "chr1", [(0, L)], K)
    kern_v2 = time_function(fused, "chr1", [(0, L)], K, "v2")
    res = fused.conservation("chr1", 0, L, K)
    t0 = time.perf_counter()
    format_conservation(res)
    format_ms = (time.perf_counter() - t0) * 1e3
    emit("phase3_headline", intervals=store.num_intervals, n_docs=store.n_docs, L=L, k=K,
         store_build_s=build_s, cli_query_s=cli_s, cli_stages_s=cli_stages, cli_host=cli_host,
         streamed_columns=streamed, launches=launches, exact_cli_bytes=True, engine_init_s=init_s, engine_init_stages=init_stages,
         setup_peak_device_bytes=setup_peak, steady_device_bytes=steady, card_layout=layout,
         window_params_vs_numpy=params,
         reference_loop_s=ref_s, mbp_s=mbp_s, query_wall_ms=query_wall,
         k_sweep_exact=[21, 51, 101], over_cap_exact=over_cap, query_ops=ops,
         query_ops_v2=ops_v2, capped_query_ops=capped_ops, no_wait_query=no_wait,
         capped_no_wait_query=capped_no_wait,
         layers_ms={"window_params": window_fn["ms"],
                    "window_params_with_count_read": window_fn["wall_with_count_read_ms"]["median"],
                    "v1_function": kern["ms"], "format_output": format_ms},
         window_kernel=window_fn, kernel=kern, kernel_v2=kern_v2)
    return launches, kern, kern_v2, window_fn, store, mbp_s


def batch_windows(pivot_len: int) -> list[tuple[int, int]]:
    """16 staggered 1 Mbp windows over the pivot."""
    span = pivot_len - BATCH_LEN
    return [(round(i * span / (BATCH_WINDOWS - 1)), round(i * span / (BATCH_WINDOWS - 1)) + BATCH_LEN)
            for i in range(BATCH_WINDOWS)]


def phase_batched(device, store):
    """conservation_batch at the headline with v1 and v2: one launch for the
    whole batch, every window == the single-window output (and v2's == v1's),
    window 3's first 16 Kbp == the reference loop; each function's device
    time on the batch and the device operations of one batch of each.
    Returns the single-window outputs and the timings {v1, v2}."""
    from memo_tpu_torch.ops.fused_query import fused_query_rows
    from memo_tpu_torch.ops.fused_query_v2 import fused_query_v2_rows
    from memo_tpu_torch.query.engine import QueryEngine

    wins = batch_windows(PIVOT_LEN)
    sub = min(1 << 14, BATCH_LEN)
    ref = reference_query_np(store, wins[3][0], wins[3][0] + sub, K)
    fields, singles, kerns = {}, None, {}
    for version in ("v1", "v2"):
        eng = QueryEngine(store, backend="fused", device=device, chunk_positions=PIVOT_LEN,
                          device_output=True, stratify=False, kernel_version=version)
        fused_query_rows.launches = fused_query_v2_rows.launches = 0
        outs = eng.conservation_batch("chr1", wins, K)
        sync(device)
        launches = {"v1": fused_query_rows.launches, "v2": fused_query_v2_rows.launches}
        check(launches == {"v1": int(version == "v1"), "v2": int(version == "v2")},
              f"{version} batch of {len(wins)} windows ran as one launch: {launches}")
        single = [eng.conservation("chr1", qs, qe, K) for qs, qe in wins]
        for (qs, qe), got, one in zip(wins, outs, single):
            check(torch.equal(got, one), f"{version} batch window {qs}-{qe} == single window")
        if singles is not None:
            for (qs, qe), got, one in zip(wins, outs, singles):
                check(np.array_equal(got.cpu().numpy(), one), f"v2 batch window {qs}-{qe} == v1")
        check(np.array_equal(outs[3][:sub].cpu().numpy(), ref), f"{version} window 3 == reference loop")
        batch_s = wall_median_s(lambda: eng.conservation_batch("chr1", wins, K), device)
        single_s = wall_median_s(lambda: eng.conservation("chr1", *wins[0], K), device)
        ops = query_graphs(eng, "chr1", wins, K)
        kerns[version] = time_function(eng, "chr1", wins, K, version)
        if version == "v1":
            kerns["window"] = time_window_params(eng, "chr1", wins, K)
        fields[version] = {"launches": launches[version], "batch_wall_ms": batch_s * 1e3,
                           "per_window_ms": batch_s * 1e3 / len(wins),
                           "single_window_ms": single_s * 1e3,
                           "batch_mbp_s": len(wins) * BATCH_LEN / batch_s / 1e6,
                           "query_ops": ops, "kernel": kerns[version]}
        if version == "v1":
            singles = [o.cpu().numpy() for o in single]
        del eng
    emit("phase7_batched", windows=len(wins), window_len=BATCH_LEN, k=K,
         exact_vs_single=True, exact_v2_vs_v1=True, exact_window3_vs_reference=True, **fields)
    return singles, kerns


def phase_hprc(device, tmp: str):
    """The n=90 store through the stratified engine: its set-up split into
    stages and its peak device memory, bucket 0's layout built on the card
    against the numpy build, the whole window timed and spot-checked, and a
    CLI ``-r`` query of the saved index (uncompressed, also for phase 10)
    split into stages, its bytes == the engine's output."""
    from memo_tpu_torch import cli
    from memo_tpu_torch.query.engine import QueryEngine
    from memo_tpu_torch.query.output import format_conservation

    L = LARGE_PIVOT_LEN
    t0 = time.perf_counter()
    store = build_large_store(np.random.default_rng(SEED))
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    npz = os.path.join(tmp, "hprc.npz")
    store.save(npz, compressed=False)
    save_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    eng, init_s, init_stages = timed_stages(lambda: QueryEngine(
        store, backend="fused", device=device, chunk_positions=L,
        max_intervals_per_chunk=1 << 25, device_output=True))
    setup_peak = torch.cuda.max_memory_allocated()
    steady = torch.cuda.memory_allocated()
    check(eng._children is not None, "HPRC-width store is stratified")
    bucket0 = eng._children[0][1]
    layout = layout_check(bucket0)
    spots = [(WINDOW, WINDOW + (1 << 15)), (L - (1 << 15) - 7, L - 7)]
    params = params_check(bucket0, "chr1", [[(0, L)], spots, batch_windows(L)])
    dt = wall_median_s(lambda: eng.conservation("chr1", 0, L, K), device, reps=HPRC_REPS)
    out = eng.conservation("chr1", 0, L, K).cpu().numpy()
    stats = eng.last_stats.as_dict()
    peak = torch.cuda.max_memory_allocated()
    for sub_qs in (WINDOW, L - (1 << 15) - 7):
        sub = (sub_qs, sub_qs + (1 << 15))
        check(np.array_equal(out[sub[0]:sub[1]], reference_query_np(store, *sub, K)),
              f"HPRC spot window {sub}")
    buckets = [(lb, child._layout.num_rows) for lb, child in eng._children]
    sweep = k_sweep(eng, "chr1", L, device, store=store)
    # k=51: bucket 32's 2 Mbp window passes the 2^25 cap and runs whole.
    no_wait = no_wait_query(eng, "chr1", 0, L, 51, plain=True)
    check(no_wait["over_cap"], "n90's window at k=51 is over the cap")
    del eng, bucket0
    torch.cuda.empty_cache()
    cli_out = os.path.join(tmp, "hprc_cons.txt")
    rc, cli_s, cli_stages, cli_host = timed_cli(
        ["query", "-b", npz, "-k", str(K), "-r", f"chr1:0-{L}", "-o", cli_out,
         "--device", device.type], store.num_records + 1)
    check(rc == 0, "n90 CLI query exit code")
    check_streamed(cli_stages, cli_host, "n90 CLI -r (stored .npz)")
    with open(cli_out, "rb") as fh:
        check(fh.read() == format_conservation(out), "n90 CLI bytes == the engine's output")
    streamed = streamed_columns_check(store, npz, device)
    torch.cuda.empty_cache()
    emit("phase4_hprc", intervals=store.num_intervals, n_docs=store.n_docs, L=L, k=K,
         store_build_s=build_s, store_save_s=save_s, engine_init_s=init_s,
         engine_init_stages=init_stages, setup_peak_device_bytes=setup_peak,
         steady_device_bytes=steady, bucket0_window_params_vs_numpy=params, mbp_s=L / dt / 1e6, last_stats=stats, buckets=buckets, peak_device_bytes=peak,
         spot_windows_exact=2, bucket0_card_layout=layout, cli_query_s=cli_s,
         cli_stages_s=cli_stages, cli_host=cli_host, streamed_columns=streamed,
         exact_cli_bytes=True, k_sweep=sweep, no_wait_query_k51=no_wait)
    return store


def bucket_device_ms(eng, record: str, windows, k: int) -> dict:
    """The device times (CUDA events) of what a query of ``windows`` (one
    launch, at their longest length) queues in each bucket of the
    stratified engine ``eng`` that can mark at ``k``: its window step and
    its v1 function; their sum over the buckets."""
    from memo_tpu_torch.ops.fused_query import fused_query_rows

    L = max(qe - qs for qs, qe in windows)
    starts = [qs for qs, _ in windows]
    per = {}
    for lb, child in eng._children:
        if lb >= k - 1:
            continue
        wp = child._window_params(record, starts, L, k)
        C = child.n_docs
        per[lb] = {
            "window_step_ms": kernel_ms(lambda: child._window_params(record, starts, L, k)),
            "v1_function_ms": kernel_ms(lambda: fused_query_rows(
                child._d, wp.params, wp.prefix, k=k, L=L, C=C, n_docs=C, membership=False),
                reps=5),
            "candidate_rows": int(wp.counts.sum())}
    return {"buckets": per, "sum_ms": sum(b["window_step_ms"] + b["v1_function_ms"]
                                          for b in per.values())}


def k_sweep(eng, record: str, L: int, device, reps: int = HPRC_REPS,
            store=None) -> dict:
    """The stratified engine ``eng`` (v1, output left on the card) at each k
    of K_SWEEP: the live buckets; the wall of one window [0, L) and of the
    batch of 16 staggered 1 Mbp windows (medians of ``reps``, spread); the
    sum over live buckets of their device times for each
    (:func:`bucket_device_ms`), and each wall less that sum. Where ``store``
    is given, batch window 3 == its single-window query, and a 4 Kbp spot of
    the window == the reference loop."""
    wins = batch_windows(L)
    out = {}
    for k in K_SWEEP:
        single = spread_ms(walls_s(lambda: eng.conservation(record, 0, L, k), device, reps))
        batch = spread_ms(walls_s(lambda: eng.conservation_batch(record, wins, k), device, reps))
        if store is not None:
            got = eng.conservation_batch(record, wins, k)[3]
            check(torch.equal(got, eng.conservation(record, *wins[3], k)),
                  f"n90 k={k}: batch window 3 == single window")
            spot = (WINDOW, WINDOW + (1 << 12))
            check(np.array_equal(eng.conservation(record, *spot, k).cpu().numpy(),
                                 reference_query_np(store, *spot, k)),
                  f"n90 k={k}: spot {spot} == reference loop")
        one, many = bucket_device_ms(eng, record, [(0, L)], k), bucket_device_ms(eng, record, wins, k)
        out[k] = {"live_buckets": list(one["buckets"]), "single_wall_ms": single,
                  "batch_wall_ms": batch, "single_device_ms": one, "batch_device_ms": many,
                  "single_host_gap_ms": single["median"] - one["sum_ms"],
                  "batch_host_gap_ms": batch["median"] - many["sum_ms"]}
    return out


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


def phase_full_width(device, large_store) -> dict:
    """The stratified engine with v2 at the n=90 store (bucket 0 runs at
    k=31), at a 160-genome store and at dense_small (tools/kernel_lab.py's
    256 Kbp pivot at n=90 density, built here): spot windows exact against
    the reference loop; on bucket 0's whole window, v1 and v2 exact against
    the plain version, their device times and the bounds."""
    from memo_tpu_torch.index.builder import store_from_ms
    from memo_tpu_torch.ops.fused_query_v2 import fused_query_v2_rows
    from memo_tpu_torch.query.engine import QueryEngine

    t0 = time.perf_counter()
    ms = synth_ms(np.random.default_rng(SEED), WIDE_LEN, WIDE_DOCS - 1, K, gap=30)
    wide = store_from_ms([ms], ["chr1"], [WIDE_LEN], WIDE_DOCS, "conservation")
    wide_build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ms = synth_ms(np.random.default_rng(SEED), DENSE_LEN, DENSE_DOCS - 1, K, gap=25)
    dense = store_from_ms([ms], ["chr1"], [DENSE_LEN], DENSE_DOCS, "conservation")
    del ms
    dense_build_s = time.perf_counter() - t0
    cells = (
        ("n90", large_store, LARGE_PIVOT_LEN,
         ((WINDOW, 1 << 15), (LARGE_PIVOT_LEN - (1 << 15) - 7, 1 << 15))),
        ("n160", wide, WIDE_LEN, ((1 << 16, 1 << 14),)),
        ("dense_small", dense, DENSE_LEN, ((1 << 16, 1 << 14),)),
    )
    fields = {}
    for name, store, L, spots in cells:
        eng = QueryEngine(store, backend="fused", device=device, chunk_positions=L,
                          max_intervals_per_chunk=1 << 25, device_output=True, kernel_version="v2")
        fused_query_v2_rows.launches = 0
        out = eng.conservation("chr1", 0, L, K).cpu().numpy()
        launches = fused_query_v2_rows.launches
        check(launches > 0, f"{name}: the v2 engine launched the v2 kernel")
        for qs, n in spots:
            check(np.array_equal(out[qs:qs + n], reference_query_np(store, qs, qs + n, K)),
                  f"{name} v2 spot window {qs}-{qs + n}")
        dt = wall_median_s(lambda: eng.conservation("chr1", 0, L, K), device, reps=HPRC_REPS)
        child = eng._children[0][1] if eng._children else eng
        exact = kernel_case(child, "chr1", [(0, L)], K, False, kernel_functions())
        v2 = time_function(child, "chr1", [(0, L)], K, "v2")
        v1 = time_function(child, "chr1", [(0, L)], K)
        fields[name] = {"intervals": store.num_intervals, "n_docs": store.n_docs, "L": L,
                        "stratified": eng._children is not None, "v2_launches": launches,
                        "spot_windows_exact": len(spots), "bucket0_exact": exact,
                        "v2_mbp_s": L / dt / 1e6, "kernel_v2": v2, "kernel_v1": v1}
        del eng, child
        torch.cuda.empty_cache()
    emit("phase8_full_width", k=K, wide_store_build_s=wide_build_s,
         dense_store_build_s=dense_build_s, **fields)
    return fields


def phase_cli_regions(device, tmp: str, singles: list[np.ndarray], torch_mbp_s: float) -> int:
    """``query --regions-file`` with the 16 batch windows at the headline,
    through strategies auto (resident here, one v1 launch for the whole
    record), batched, batched with v2 and position: every file
    byte-identical across the runs and to
    write_conservation of the single-window outputs. Returns the v2 run's
    launches."""
    from memo_tpu_torch import cli
    from memo_tpu_torch.ops.fused_query import fused_query_rows
    from memo_tpu_torch.ops.fused_query_v2 import fused_query_v2_rows
    from memo_tpu_torch.query.output import format_conservation

    wins = batch_windows(PIVOT_LEN)
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
            ("auto", "auto", None, (1, 0)),  # resident: one v1 launch for the record
            ("batched", "batched", None, (1, 0)),
            ("batched_v2", "batched", "v2", (0, 1)),
            ("position", "position", None, (0, 0)),
        ):
            out = os.path.join(tmp, f"regions_{name}")
            fused_query_rows.launches = fused_query_v2_rows.launches = 0
            t0 = time.perf_counter()
            with kernel_env(version):
                rc = cli.main(["query", "-b", npz, "-k", str(K), "--regions-file", regions,
                               "-o", out, "--strategy", strategy, "--device", device.type])
            wall = time.perf_counter() - t0
            launches = (fused_query_rows.launches, fused_query_v2_rows.launches)
            check(rc == 0, f"CLI --regions-file --strategy {name} exit code")
            check(launches == expect, f"CLI {name}: launches (v1, v2) {launches} != {expect}")
            for (qs, qe), w in zip(wins, want):
                with open(f"{out}.chr1_{qs}_{qe}.txt", "rb") as fh:
                    check(fh.read() == w, f"CLI {name} window {qs}-{qe} bytes == single window")
            runs[name] = {"cli_s": wall, "launches_v1": launches[0], "launches_v2": launches[1]}
    finally:
        cli.log.removeHandler(handler)
    check("--strategy auto resolved to 'resident'" in records, f"auto resolved to resident: {records}")
    dispatch = resident_dispatch(npz, device, wins, singles)
    check(dispatch["host_copies_a_call"] == 1 and dispatch["device_copies_a_call"] == 0,
          f"resident's windows come to the host in one copy: {dispatch}")
    emit("phase9_cli_regions", windows=len(wins), strategies=runs, auto_resolved="resident",
         byte_identical=True, torch_backend_headline_mbp_s=torch_mbp_s, resident_dispatch=dispatch)
    return runs["batched_v2"]["launches_v2"]


def resident_dispatch(npz: str, device, wins, singles: list[np.ndarray]) -> dict:
    """ResidentShardedQuery set up from ``npz`` (the headline store, saved):
    the 16 batch windows of a new dispatch each time, median wall of
    WALL_REPS, brought to the host (with the copies to the host counted:
    through ``engine._copy_back``) and left on the card, checked exact
    against the single-window outputs."""
    from memo_tpu_torch.index.store import IntervalStore
    from memo_tpu_torch.parallel import ResidentShardedQuery
    from memo_tpu_torch.query import engine as engine_mod

    out, copies, real = {}, [], engine_mod._copy_back

    def counted(t):
        copies.append(tuple(t.shape))
        return real(t)

    engine_mod._copy_back = counted
    try:
        for where, device_output in (("host", False), ("device", True)):
            rq = ResidentShardedQuery(IntervalStore.load(npz), device, record="chr1",
                                      device_output=device_output)

            def dispatch():
                rq._full_cache.clear()
                return rq.conservation_windows(wins, K)

            got = dispatch()
            for (qs, qe), g, one in zip(wins, got, singles):
                g = g if where == "host" else g.cpu().numpy()
                check(np.array_equal(g, one), f"resident dispatch to the {where}: {qs}-{qe}")
            copies.clear()
            walls = walls_s(dispatch, device)
            out[f"{where}_ms"] = spread_ms(walls)
            out[f"{where}_copies_a_call"] = len(copies) / (len(walls) + 1)  # + the warm-up
            del rq
    finally:
        engine_mod._copy_back = real
    return out


def phase_membership(device) -> None:
    from memo_tpu_torch.index.builder import store_from_ms
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
    check(np.array_equal(fused.membership("chr1", 777, 8_777, 31),
                         reference_membership_np(store, 777, 8_777, 31)),
          "membership fused == reference loop 777-8777")
    emit("phase5_membership", intervals=store.num_intervals, n_docs=MEMB_DOCS, L=MEMB_LEN,
         exact=True)


@contextlib.contextmanager
def slab_events():
    """CUDA events around every ``parallel.sharded._slab`` call inside the
    block (the diff-array ops of one bucket's windows on this rank); yields
    the list of (start, end) event pairs."""
    from memo_tpu_torch.parallel import sharded

    real, pairs = sharded._slab, []

    def timed(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*args, **kwargs)
        end.record()
        pairs.append((start, end))
        return out

    sharded._slab = timed
    try:
        yield pairs
    finally:
        sharded._slab = real


def mesh_walls(store, mesh, singles: list[np.ndarray]) -> dict[str, float]:
    """The 16 batch windows through ShardedQuery (position, interval) and
    ResidentShardedQuery on ``mesh``: each strategy once, checked exact
    against the single-window outputs, then the median wall of MESH_REPS
    more, each from construction (the placement) to the last window on the
    host; and each one's placement and its dispatch (from a placed store
    to the last window on the host) apart, with, for position and
    interval, the diff-array ops' CUDA-event time within the dispatch, and
    for resident the dispatch to the last window left on the device."""
    from memo_tpu_torch.parallel import ResidentShardedQuery, ShardedQuery

    wins = batch_windows(PIVOT_LEN)
    regions = [("chr1", qs, qe) for qs, qe in wins]
    runs = {
        "position": lambda: ShardedQuery(store, mesh, "position").conservation(regions, K),
        "interval": lambda: ShardedQuery(store, mesh, "interval").conservation(regions, K),
        "resident": lambda: ResidentShardedQuery(store, mesh, record="chr1")
        .conservation_windows(wins, K),
    }
    walls = {}
    for name, fn in runs.items():
        for (qs, qe), got, one in zip(wins, fn(), singles):
            check(np.array_equal(got, one), f"mesh {mesh.shape} {name} window {qs}-{qe} == single")
        times = []
        for _ in range(MESH_REPS):
            sync(mesh.device)
            t0 = time.perf_counter()
            fn()
            sync(mesh.device)
            times.append(time.perf_counter() - t0)
        walls[f"{name}_ms"] = statistics.median(times) * 1e3
    # Position's and interval's parts: the placement; the dispatch, to the
    # last window on the host; the ops' device time within it.
    times = {f"{name}_{part}_ms": [] for name in ("position", "interval")
             for part in ("place", "dispatch", "ops")}
    for _ in range(MESH_REPS):
        for name in ("position", "interval"):
            sync(mesh.device)
            t0 = time.perf_counter()
            sq = ShardedQuery(store, mesh, name)
            sync(mesh.device)
            t1 = time.perf_counter()
            with slab_events() as pairs:
                outs = sq.conservation(regions, K)
            sync(mesh.device)
            t2 = time.perf_counter()
            check(all(np.array_equal(o, one) for o, one in zip(outs, singles)),
                  f"mesh {mesh.shape} {name} windows == single")
            times[f"{name}_place_ms"].append(t1 - t0)
            times[f"{name}_dispatch_ms"].append(t2 - t1)
            times[f"{name}_ops_ms"].append(sum(a.elapsed_time(b) for a, b in pairs) / 1e3)
            del sq
    # Resident's parts: the placement; the windows of its first (k, mode),
    # on the host; and the same with the windows left on the device, as
    # phase 7 times batched.
    times |= {"resident_place_ms": [], "resident_dispatch_ms": [],
              "resident_device_dispatch_ms": []}
    for _ in range(MESH_REPS):
        for device_output in (False, True):
            sync(mesh.device)
            t0 = time.perf_counter()
            rq = ResidentShardedQuery(store, mesh, record="chr1", device_output=device_output)
            sync(mesh.device)
            t1 = time.perf_counter()
            outs = rq.conservation_windows(wins, K)
            sync(mesh.device)
            t2 = time.perf_counter()
            if device_output:
                times["resident_device_dispatch_ms"].append(t2 - t1)
                check(all(np.array_equal(o.cpu().numpy(), one) for o, one in zip(outs, singles)),
                      f"mesh {mesh.shape} resident windows on the device == single")
            else:
                times["resident_place_ms"].append(t1 - t0)
                times["resident_dispatch_ms"].append(t2 - t1)
    walls.update({name: statistics.median(t) * 1e3 for name, t in times.items()})
    return walls


def phase_mesh(tmp: str, singles: list[np.ndarray]) -> None:
    """The multi-device layer: this script again as :func:`mesh_child` under
    torchrun, one rank per CUDA device, in an NCCL group; its result comes
    back in phase10.json."""
    np.savez(os.path.join(tmp, "singles.npz"), *singles)
    n = torch.cuda.device_count()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           str(n), os.path.abspath(__file__), MESH_CHILD, tmp]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=MESH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)  # torchrun and its ranks
        proc.communicate()
        raise RuntimeError(f"chip_smoke: phase 10's torchrun ran past {MESH_TIMEOUT_S} s")
    torchrun_s = time.perf_counter() - t0
    if proc.returncode != 0:
        print(log[-8000:], file=sys.stderr)
    check(proc.returncode == 0, f"phase 10: torchrun of {n} rank(s) exit code {proc.returncode}")
    with open(os.path.join(tmp, "phase10.json")) as fh:
        result = json.load(fh)
    emit("phase10_mesh", devices=n, torchrun_s=torchrun_s, **result)


def mesh_child(tmp: str) -> int:
    """One rank of phase 10 (started by torchrun): joins the NCCL group and on
    the (1, world) mesh runs the dry run; ``query --regions-file --mesh
    1,<world>`` with position, interval and resident, byte for byte against
    phase 9's files; the 16 batch windows through each strategy, exact
    against the single-window outputs and timed in turns on the group's mesh
    and on the in-process one-device layout (no collective), in this
    process: in-process, group, group, in-process; and the n=90 store from phase
    4's .npz through resident (placement, query, peak device memory),
    position and interval, exact against the port's numpy engine. Every rank
    checks its own outputs; rank 0 writes phase10.json."""
    import torch.distributed as dist

    from memo_tpu_torch import cli
    from memo_tpu_torch.index.store import IntervalStore
    from memo_tpu_torch.parallel import (Mesh, ResidentShardedQuery, ShardedQuery, initialize,
                                         make_mesh)
    from memo_tpu_torch.parallel.distributed import shutdown
    from memo_tpu_torch.parallel.dryrun import dryrun_multichip
    from memo_tpu_torch.query.engine import QueryEngine

    t0 = time.perf_counter()
    initialize(device="cuda")
    rank, n = dist.get_rank(), dist.get_world_size()
    check(dist.get_backend() == "nccl", f"the CUDA group is NCCL, not {dist.get_backend()}")
    mesh = make_mesh(1, n)
    init_s = time.perf_counter() - t0
    dp = 2 if n % 2 == 0 and n > 1 else 1
    t0 = time.perf_counter()
    dry = dryrun_multichip(make_mesh(dp, n // dp))
    dryrun_s = time.perf_counter() - t0

    wins = batch_windows(PIVOT_LEN)
    npz, regions = os.path.join(tmp, "headline.npz"), os.path.join(tmp, "regions.txt")
    cli_s = {}
    for strategy in ("position", "interval", "resident"):
        out = os.path.join(tmp, f"mesh_{strategy}")
        t0 = time.perf_counter()
        rc = cli.main(["query", "-b", npz, "-k", str(K), "--regions-file", regions, "-o", out,
                       "--mesh", f"1,{n}", "--strategy", strategy, "--device", "cuda"])
        dist.barrier()  # rank 0 has written the files
        cli_s[strategy] = time.perf_counter() - t0
        check(rc == 0, f"CLI --mesh 1,{n} --strategy {strategy} exit code")
        for qs, qe in wins:
            name = f"chr1_{qs}_{qe}.txt"
            with open(f"{out}.{name}", "rb") as got, \
                    open(os.path.join(tmp, f"regions_position.{name}"), "rb") as want:
                check(got.read() == want.read(), f"--mesh 1,{n} {strategy} {name} == phase 9's")

    store = IntervalStore.load(npz)
    with np.load(os.path.join(tmp, "singles.npz")) as z:
        singles = [z[f"arr_{i}"] for i in range(len(wins))]
    in_process = Mesh(1, 1, mesh.device)  # the layout without a group: no collective
    walls = {"in_process": [], "group": []}
    for name, where in (("in_process", in_process), ("group", mesh), ("group", mesh),
                        ("in_process", in_process)):
        walls[name].append(mesh_walls(store, where, singles))
    del store
    # The collectives alone, at the batch's shapes: the all-gather of a
    # conservation output [16, L/sp] over sp and the interval strategy's
    # reduce-scatter of int32 partial counts [L, 16, C=16].
    L_div = BATCH_LEN // n * n
    out = torch.ones((BATCH_WINDOWS, L_div // n), dtype=torch.int32, device=mesh.device)
    part = torch.ones((L_div, BATCH_WINDOWS, N_DOCS), dtype=torch.int32, device=mesh.device)
    collective_ms = {
        "all_gather_bytes": out.numel() * 4 * n,
        "all_gather_ms": wall_median_s(lambda: mesh.all_gather(out, "sp"), mesh.device) * 1e3,
        "reduce_scatter_bytes": part.numel() * 4,
        "reduce_scatter_ms": wall_median_s(lambda: mesh.reduce_scatter(part, "sp"), mesh.device)
        * 1e3,
    }
    del out, part

    t0 = time.perf_counter()
    large = IntervalStore.load(os.path.join(tmp, "hprc.npz"))
    load_s = time.perf_counter() - t0
    oracle = QueryEngine(large, backend="numpy", device="cpu")
    L = LARGE_PIVOT_LEN
    spots = [(WINDOW, WINDOW + (1 << 15)), (L - (1 << 15) - 7, L - 7), (777_777, 781_873)]
    want = [oracle.conservation("chr1", qs, qe, K) for qs, qe in spots]
    want_memb = oracle.membership("chr1", *spots[2], K)
    torch.cuda.reset_peak_memory_stats(mesh.device)
    t0 = time.perf_counter()
    rq = ResidentShardedQuery(large, mesh, k_max=1024)
    place_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = {"resident": rq.conservation_windows(spots, K)}
    query_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(mesh.device)
    got_memb = {"resident": rq.membership_windows(spots[2:], K)[0]}
    stats = rq.stats()
    del rq
    torch.cuda.empty_cache()
    n90_ms = {}
    for strategy in ("position", "interval"):
        t0 = time.perf_counter()
        sq = ShardedQuery(large, mesh, strategy)
        got[strategy] = sq.conservation([("chr1", qs, qe) for qs, qe in spots], K)
        n90_ms[strategy] = (time.perf_counter() - t0) * 1e3
        got_memb[strategy] = sq.membership([("chr1", *spots[2])], K)[0]
    for name in got:
        for (qs, qe), g, w in zip(spots, got[name], want):
            check(np.array_equal(g, w), f"n90 {name} {qs}-{qe} == numpy engine")
        check(got_memb[name].shape == (spots[2][1] - spots[2][0], LARGE_N_DOCS)
              and np.array_equal(got_memb[name], want_memb), f"n90 {name} membership == numpy engine")
    if rank == 0:
        result = {"backend": dist.get_backend(), "world": n, "mesh": mesh.shape,
                  "init_s": init_s, "dryrun": dry, "dryrun_s": dryrun_s, "cli_s": cli_s,
                  "cli_bytes_equal_phase9": True, "batch_walls_in_turns": walls,
                  "collectives": collective_ms,
                  "batch_exact": True,
                  "n90": {"load_s": load_s, "resident_place_s": place_s,
                          "resident_query_s": query_s, "resident_peak_device_bytes": peak,
                          "resident_stats": stats, "sharded_ms": n90_ms, "windows": spots,
                          "exact_vs_numpy": True}}
        with open(os.path.join(tmp, "phase10.json"), "w") as fh:
            json.dump(result, fh)
    shutdown()
    return 0


def pad_bytes(engines) -> dict:
    """The sentinel rows of the engines' six placed int32 tensors, in bytes:
    as placed, and as a pad of min(2^25, next_pow2(rows)) rows a bucket (the
    rule that sized them when every reader could slice a whole candidate
    cap past a range) would place them, reckoned from the bucket rows."""
    rows = [e._layout.num_rows for e in engines]
    placed = sum((t.numel() - n) * t.element_size() for e, n in zip(engines, rows) for t in e._d)
    pow2 = sum(24 * min(1 << 25, 1 if n <= 1 else 1 << (n - 1).bit_length()) for n in rows)
    return {"bucket_rows": rows, "placed_pad_bytes": placed, "pow2_capped_pad_bytes": pow2}


def wide_function(engine, version: str, membership: bool, wp, L: int) -> dict:
    """``version``'s kernel function (:func:`kernel_functions`, its
    column groups' launches counted) on the windows of ``wp``: exact
    against the plain version over all columns; its device operations
    counted by CUDA graph capture (the groups' kernels alone); its device time,
    the plain version's and its bound (12 bytes a candidate row read once,
    plus the output)."""
    from memo_tpu_torch.ops.fused_query import fused_query_rows_reference

    C = engine.n_docs
    fn = kernel_functions()[version]
    kw = dict(k=K, L=L, C=C, n_docs=C, membership=membership)

    def run():
        return fn(engine._d, wp.params, wp.prefix, **kw)

    want = fused_query_rows_reference(engine._d, wp.params, wp.prefix, **kw)
    before = fn.launches
    got = run()
    groups = fn.launches - before
    err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
    where = f"C={C} {version} membership={membership}"
    check(err == 0, f"{where}: the grouped kernel function != the plain version")
    check(groups == C1000_GROUPS, f"{where}: {groups} launches, want {C1000_GROUPS}")
    del got, want
    per_group = len(V1_KERNELS if membership and version == "v1"
                    else kernels_of(version, C, wp.params.shape[0], L))
    graph = graph_ops(run)
    want_graph = {"kernel": groups * per_group}
    check(graph == want_graph, f"{where}: device operations {graph}, want {want_graph}")
    ms = kernel_ms(run, reps=5)
    plain = kernel_ms(lambda: fused_query_rows_reference(engine._d, wp.params, wp.prefix, **kw),
                      reps=2)
    n_win = wp.params.shape[0]
    rows = int(wp.counts.sum())
    n_bytes = rows * 12 + n_win * L * (C if membership else 4) + (5 + C) * n_win * 4
    n_ops = n_win * L * C + rows  # one scan add per (position, column), one atomic per row
    bound, bound_by = bound_ms(n_bytes, n_ops)
    return {"version": version, "membership": membership, "C": C, "L": L, "windows": n_win,
            "candidate_rows": rows, "column_groups": groups, "graph": graph,
            "max_abs_err": err, "ms": ms, "plain_ms": plain, "bytes": n_bytes, "ops": n_ops,
            "bound_ms": bound, "bound_by": bound_by, "bound_share": bound / ms}


def phase_wide(device, card: str) -> dict:
    """The wide cell: synth_ms at 1000 genomes over a 256 Kbp pivot (gap
    30, as phase 8 builds n160), through the default engine with v1 and with
    v2: the whole pivot in both modes (the kernel launched per column
    group; launches counted), spot windows exact against the reference
    loops, v2 == v1; walls; then on the bucket that marks at k=31, each
    kernel function in both modes (:func:`wide_function`). Prints its line
    beside the card's name and power limit."""
    from memo_tpu_torch.index.builder import store_from_ms
    from memo_tpu_torch.ops.fused_query import fused_query_rows
    from memo_tpu_torch.ops.fused_query_v2 import fused_query_v2_rows
    from memo_tpu_torch.query.engine import QueryEngine
    from memo_tpu_torch.query.window import window_params

    L, C = C1000_LEN, C1000_DOCS
    t0 = time.perf_counter()
    ms = synth_ms(np.random.default_rng(SEED), L, C - 1, K, gap=C1000_GAP)
    build_ms_s = time.perf_counter() - t0
    store = store_from_ms([ms], ["chr1"], [L], C, "conservation")
    del ms
    build_s = time.perf_counter() - t0
    spots = ((L // 4, C1000_SPOT), (L - C1000_SPOT - 5, C1000_SPOT))
    engines, first, functions = {}, None, {}
    for version in ("v1", "v2"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        eng, init_s, stages = timed_stages(lambda: QueryEngine(
            store, device=device, device_output=True, kernel_version=version))
        steady = torch.cuda.memory_allocated()
        live = [c for lb, c in (eng._children or [(0, eng)]) if lb < K - 1]
        fused_query_rows.launches = fused_query_v2_rows.launches = window_params.launches = 0
        outs = (eng.conservation("chr1", 0, L, K), eng.membership("chr1", 0, L, K))
        sync(device)
        launched = (fused_query_rows if version == "v1" else fused_query_v2_rows).launches
        window_launches = window_params.launches
        want = 2 * C1000_GROUPS * len(live)
        check(launched == want, f"C={C} {version}: {launched} launches, want {want} "
                                "(both modes, each column group of each live bucket)")
        check(tuple(outs[0].shape) == (L,) and tuple(outs[1].shape) == (L, C),
              f"C={C} {version} output shapes")
        outs = tuple(o.cpu().numpy() for o in outs)
        for qs, n in spots:
            check(np.array_equal(outs[0][qs:qs + n], reference_query_np(store, qs, qs + n, K)),
                  f"C={C} {version} conservation spot {qs}-{qs + n} == reference loop")
            check(np.array_equal(outs[1][qs:qs + n],
                                 reference_membership_np(store, qs, qs + n, K)),
                  f"C={C} {version} membership spot {qs}-{qs + n} == reference loop")
        if first is None:
            first = outs
        else:
            check(all(np.array_equal(a, b) for a, b in zip(first, outs)), f"C={C} v2 == v1")
        walls = {mode: spread_ms(walls_s(lambda: getattr(eng, mode)("chr1", 0, L, K), device,
                                         reps=HPRC_REPS))
                 for mode in ("conservation", "membership")}
        if version == "v1":  # both kernel functions on the bucket that marks
            wp, n = v1_inputs(live[0], "chr1", [(0, L)], K)
            functions = {f"{v}_{mode}": wide_function(live[0], v, mode == "membership", wp, n)
                         for v in ("v1", "v2") for mode in ("conservation", "membership")}
            del wp
        engines[version] = {"engine_init_s": init_s, "engine_init_stages": stages,
                            "stratified": eng._children is not None, "live_buckets": len(live),
                            "steady_device_bytes": steady,
                            "peak_device_bytes": torch.cuda.max_memory_allocated(),
                            "launches": launched, "window_launches": window_launches,
                            "wall_ms": walls, "mbp_s": {m: L / w["median"] / 1e3
                                                        for m, w in walls.items()}}
        del eng, live, outs
    del first
    torch.cuda.empty_cache()
    fields = {"C": C, "L": L, "k": K, "gap": C1000_GAP, "intervals": store.num_intervals,
              "ms_build_s": build_ms_s, "store_build_s": build_s,
              "column_groups": C1000_GROUPS,
              "spot_windows_exact": [list(s) for s in spots], "engines": engines,
              "functions": functions}
    emit("phase13_wide", card=card, **fields)
    return fields


def chromosome_windows() -> list[tuple[int, int]]:
    """SCALE_r05's eight 2 Mbp windows: starts at linspace(0, L - 2^21, 8)."""
    starts = np.linspace(0, CHROM_LEN - CHROM_WINDOW, CHROM_WINDOWS).astype(np.int64)
    return [(int(qs), int(qs) + CHROM_WINDOW) for qs in starts]


def chunked_query(engine, device, check_batch: bool = True) -> dict:
    """A query over CHUNKED_CHUNKS position chunks of the chromosome record
    (the last one shorter) through ``engine`` (chunk_positions =
    CHROM_WINDOW, output left on the card): equal, where ``check_batch``,
    to one batch of the same chunks; its wall, median of WALL_REPS with its
    spread."""
    qs = chromosome_windows()[3][0]
    qe = qs + CHUNKED_CHUNKS * CHROM_WINDOW - CHUNKED_TAIL_CUT
    check(engine.chunk_positions == CHROM_WINDOW, "chunked query: 2 Mbp position chunks")
    got = engine.conservation("chr1", qs, qe, K)
    check(tuple(got.shape) == (qe - qs,) and got.device.type == "cuda", "chunked query: shape")
    if check_batch:
        chunks = [(a, min(a + CHROM_WINDOW, qe)) for a in range(qs, qe, CHROM_WINDOW)]
        want = torch.cat(engine.conservation_batch("chr1", chunks, K))
        check(torch.equal(got, want), "a query of 8 position chunks == the batch of its chunks")
    walls = walls_s(lambda: engine.conservation("chr1", qs, qe, K), device)
    return {"window": [qs, qe], "chunks": CHUNKED_CHUNKS, "equal_to_batch": check_batch,
            "wall_ms": spread_ms(walls)}


def tile_batch(engine, device, store, wins, outs) -> tuple[dict, np.ndarray]:
    """The chromosome record as one batch of 1 kbp tiles (128,000 windows,
    more than one launch takes) through ``conservation_batch``: one window
    step per live bucket, the kernel launched per window group; the tiles
    inside the eight 2 Mbp windows ``wins`` == the engine's outputs ``outs``
    of them, spot tiles == the reference loop; walls of the call (a list of
    per-tile views) and of its one device tensor (``_batch_tensor``).
    Returns the record and the tiles' conservation on the host, [128M]."""
    from memo_tpu_torch.ops import fused_query
    from memo_tpu_torch.ops.fused_query import fused_query_rows
    from memo_tpu_torch.ops.fused_query_v2 import fused_query_v2_rows
    from memo_tpu_torch.query.window import window_params

    tiles = [(qs, qs + CHROM_TILE) for qs in range(0, CHROM_LEN, CHROM_TILE)]
    n = len(tiles)
    check(n > fused_query.MAX_WINDOWS, f"{n} tiles: more than one launch takes")
    live = [c for lb, c in engine._children if lb < K - 1]
    run = fused_query_rows if engine.kernel_version == "v1" else fused_query_v2_rows
    launches, steps = run.launches, window_params.launches
    got = engine.conservation_batch("chr1", tiles, K)
    sync(device)
    groups = -(-n // fused_query.MAX_WINDOWS)
    launches, steps = run.launches - launches, window_params.launches - steps
    check(launches == groups * len(live) and steps == len(live),
          f"{n} tiles: {launches} launches and {steps} window steps, want {groups} a bucket "
          f"and one, over {len(live)} live bucket(s)")
    check(len(got) == n and all(tuple(t.shape) == (CHROM_TILE,) for t in got), "tile shapes")
    host = torch.stack(got).cpu().numpy()
    del got
    inside = 0
    for (ws, we), out in zip(wins, outs):
        t0, t1 = -(-ws // CHROM_TILE), we // CHROM_TILE
        check(np.array_equal(host[t0:t1].reshape(-1), out[t0 * CHROM_TILE - ws:t1 * CHROM_TILE - ws]),
              f"tiles {t0}-{t1} == the engine's window {ws}-{we}")
        inside += t1 - t0
    spot_tiles = (0, n * 25 // 32 + 1, n - 1)  # the middle one past 100M at 128 Mbp
    for t in spot_tiles:
        check(np.array_equal(host[t], reference_query_np(store, *tiles[t], K)),
              f"tile {tiles[t]} == reference loop")
    walls = walls_s(lambda: engine.conservation_batch("chr1", tiles, K), device, reps=3)
    tensor_walls = walls_s(lambda: engine._batch_tensor("chr1", tiles, K, False), device, reps=3)
    # The bucket's window step and kernel function apart (back-to-back calls).
    starts = [qs for qs, _ in tiles]
    wp = live[0]._window_params("chr1", starts, CHROM_TILE, K)
    step_ms = kernel_ms(lambda: live[0]._window_params("chr1", starts, CHROM_TILE, K), reps=3)
    function_ms = kernel_ms(lambda: live[0]._run_kernel(wp, K, CHROM_TILE, False), reps=3)
    rows = int(wp.counts.sum())
    bound, bound_by = bound_ms(rows * 12 + n * CHROM_TILE * 4 + wp.params.numel() * 4
                               + wp.prefix.numel() * 4, n * CHROM_TILE * engine.n_docs + rows)
    return {"version": engine.kernel_version, "windows": n, "window_len": CHROM_TILE,
            "launches": launches, "window_groups": groups, "window_steps": steps,
            "tiles_inside_windows_exact": inside, "spot_tiles_exact": list(spot_tiles),
            "batch_wall_ms": spread_ms(walls), "batch_tensor_wall_ms": spread_ms(tensor_walls),
            "mbp_s": CHROM_LEN / statistics.median(walls) / 1e6, "window_step_ms": step_ms,
            "function_ms": function_ms, "candidate_rows": rows, "function_bound_ms": bound,
            "function_bound_by": bound_by}, host.reshape(-1)


def gene_windows(rng, rec_len: int) -> list[tuple[int, int]]:
    """GENES windows sorted by start: log-normal lengths of median
    GENE_MEDIAN and mean GENE_MEAN at evenly spaced quantiles, in a random
    order, and uniform starts; one window empty and two a single position."""
    sigma = (2 * np.log(GENE_MEAN / GENE_MEDIAN)) ** 0.5
    z = np.array([statistics.NormalDist().inv_cdf((i + 0.5) / GENES) for i in range(GENES)])
    lengths = rng.permutation(np.maximum(np.rint(GENE_MEDIAN * np.exp(sigma * z)), 1))
    lengths = lengths.astype(np.int64)
    lengths[[1, GENES // 2, GENES - 1]] = (0, 1, 1)
    starts = np.sort(rng.integers(0, rec_len - lengths.max(), GENES))
    return [(int(qs), int(qs + m)) for qs, m in zip(starts, lengths)]


def plain_groups(params: np.ndarray, lengths, C: int) -> list[tuple[int, int, int]]:
    """Runs [g0, g1) of consecutive windows, each with its longest length,
    whose plain version holds at most PLAIN_SLOTS slots: a window's
    candidate rows (``params``' ranges, int64[Q, 5]) and its columns times
    the run's longest length."""
    rows = np.maximum(params[:, 1] - params[:, 0], params[:, 3] - params[:, 2])
    groups, g0, M, L = [], 0, 0, 0
    for i, m in enumerate(lengths):
        M2, L2 = max(M, int(rows[i]), 1), max(L, m, 1)
        if i > g0 and (i + 1 - g0) * max(M2, C * L2) > PLAIN_SLOTS:
            groups.append((g0, i, L))
            g0, M2, L2 = i, max(int(rows[i]), 1), max(m, 1)
        M, L = M2, L2
    groups.append((g0, len(lengths), L))
    return groups


def gene_marking_rows(store, windows, k: int, device) -> int:
    """The rows that mark a position of one of ``windows`` at k, summed,
    counted on ``device`` from the store's intervals as the benchmark counts
    them (portbench/work.py); an empty window has none."""
    from portbench.work import marking_rows

    wins = [(qs, qe, k) for qs, qe in windows if qe > qs]
    return int(marking_rows(store.start, store.end, wins, device).sum())


def ragged_function(engine, record: str, windows, k: int, version: str, rows: int) -> dict:
    """The v1 or v2 function on the ragged batch ``windows``, as
    ``conservation_batch`` launches it (each window's parameters found at
    the longest length, one packed output): its launches counted from zero
    over one call, which must be one; that call's output exact against the
    plain version with the batch's offsets (fused_query_rows_reference, run
    over :func:`plain_groups`, each at its longest length, since a window's
    positions do not depend on the length its parameters were found at);
    device times (CUDA events) of the function and of its plain version,
    and the kernels' device operations. Its bound: ``rows``, the rows that
    mark the windows, read once (12 bytes each) and every answered position
    written once (4 bytes)."""
    from memo_tpu_torch.ops.fused_query import fused_query_rows_reference, rows_tile
    from memo_tpu_torch.ops.fused_query_v2 import v2_constants
    from memo_tpu_torch.query.window import ragged_table

    fn = kernel_functions()[version]
    lengths = [qe - qs for qs, qe in windows]
    L, C, total = max(lengths), engine.n_docs, sum(lengths)
    starts, offsets = ragged_table([qs for qs, _ in windows], lengths, engine._d.start.device)
    wp = engine._window_params(record, starts, L, k)

    def run():
        return fn(engine._d, wp.params, wp.prefix, k=k, L=L, C=C, n_docs=C, membership=False,
                  offsets=offsets)

    groups = plain_groups(wp.params.cpu().numpy().astype(np.int64), lengths, C)

    def plain():
        return torch.cat([fused_query_rows_reference(
            engine._d, wp.params[g0:g1], wp.prefix[g0:g1], k=k, L=Lg, C=C, n_docs=C,
            membership=False, offsets=offsets.group(g0, g1)) for g0, g1, Lg in groups])

    fn.launches = 0
    got = run()
    torch.cuda.synchronize()
    launches = fn.launches
    where = f"{version} ragged batch of {len(windows)} windows, C={C}"
    check(launches == 1, f"{where}: one launch, got {launches}")
    want = plain()
    check(got.dtype == want.dtype and tuple(got.shape) == (total,) == tuple(want.shape),
          f"{where}: shape/dtype")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    check(err == 0, f"kernel != plain: {where}")
    del got, want
    ms = kernel_ms(run)
    plain_ms = kernel_ms(plain, reps=1)
    n_bytes = rows * 12 + total * 4
    n_ops = total * C + rows  # one scan add per (position, column), one atomic per row
    bound, bound_by = bound_ms(n_bytes, n_ops)
    ops = device_ops(run, kernels_of(version, C, len(windows), L, total))
    return {"version": version, "C": C, "L": L, "windows": len(windows), "positions": total,
            "candidate_rows": int(wp.counts.sum()), "marking_rows": rows,
            "tile": rows_tile(C) if version == "v1" else v2_constants(C)[0],
            "launches": launches, "max_abs_err": err, "plain_groups": len(groups), "ms": ms,
            "plain_ms": plain_ms, "bytes": n_bytes, "ops": n_ops, "bound_ms": bound,
            "bound_by": bound_by, "bound_share": bound / ms, "kernels_us": ops}


def rss_bytes() -> int:
    """This process's resident set now, in bytes."""
    with open("/proc/self/status") as fh:
        return next(int(line.split()[1]) for line in fh if line.startswith("VmRSS:")) * 1024


def host_memory() -> dict:
    """This process's peak resident set and the machine's memory, in bytes."""
    import resource

    with open("/proc/meminfo") as fh:
        total = next(int(line.split()[1]) for line in fh if line.startswith("MemTotal:"))
    return {"peak_rss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
            "mem_total_bytes": total * 1024}


def whole_record_errors(engine, record: str, windows, k: int, membership: bool,
                        resident_out) -> dict[str, int]:
    """Each kernel function once on ``windows`` of one bucket's engine (the
    launch resident makes over the whole record), and resident's own output
    (positions of ``record``), held window by window against the plain
    version of that window alone, which fits on the card where the whole
    launch's would not. Returns each one's error (it must be 0)."""
    from memo_tpu_torch.ops.fused_query import fused_query_rows_reference

    C = engine.n_docs
    wp, L = v1_inputs(engine, record, windows, k)
    outs = {name: fn(engine._d, wp.params, wp.prefix, k=k, L=L, C=C, n_docs=C,
                     membership=membership)
            for name, fn in kernel_functions().items()}
    outs["resident"] = resident_out
    errors = dict.fromkeys(outs, 0)
    for i, (qs, qe) in enumerate(windows):
        one, n = v1_inputs(engine, record, [(qs, qe)], k)
        want = fused_query_rows_reference(engine._d, one.params, one.prefix, k=k, L=n, C=C,
                                          n_docs=C, membership=membership)[0]
        for name, out in outs.items():
            got = out[qs:qe] if name == "resident" else out[i, :n]
            err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
            errors[name] = max(errors[name], err)
            check(err == 0, f"{name} over the whole record != plain at {qs}-{qe}, "
                            f"membership={membership}: error {err}")
    return errors


def function_ms(engine, record: str, windows, k: int, version: str, membership: bool) -> dict:
    """The v1 or v2 function on ``windows`` of one bucket's engine, by CUDA
    events, with its bound (12 bytes a candidate row and the output), for
    inputs whose plain version would not fit on the card:
    :func:`whole_record_errors` checks the outputs at this shape first."""
    fn = kernel_functions()[version]
    wp, L = v1_inputs(engine, record, windows, k)
    C = engine.n_docs
    ms = kernel_ms(lambda: fn(engine._d, wp.params, wp.prefix, k=k, L=L, C=C, n_docs=C,
                              membership=membership), reps=3)
    rows = int(wp.counts.sum())
    out_bytes = len(windows) * L * (C if membership else 4)
    bound, bound_by = bound_ms(rows * 12 + out_bytes, len(windows) * L * C + rows)
    return {"version": version, "windows": len(windows), "L": L, "candidate_rows": rows,
            "ms": ms, "bound_ms": bound, "bound_by": bound_by, "bound_share": bound / ms}


def resident_whole_record(store, npz: str, device, spots) -> tuple[dict, np.ndarray]:
    """ResidentShardedQuery over the whole record on one device, set up from
    ``npz`` (``store`` saved, stored members) as the CLI sets it up: its
    wall and stages (the slab rows streamed, ``place.upload``; the slab
    bounds, ``place.bounds``; the placement, ``place.sort_gather``,
    ``place.pad`` and ``engine.*``), the host RSS it adds (before, peak,
    after), peak device bytes, and proof that it read no column on the
    host (numpy's member reader read no large array, the four columns are
    still only in the file); conservation_full and membership_full at K,
    each timed, peak device memory; each kernel function's time on the
    dispatch's windows; the conservation at ``spots`` and the membership at
    the last spot (past 2^31 output elements at C=90 beyond 23.9M
    positions) against the reference loops over ``store``; both kernel
    functions' launches over the record's windows, and resident's outputs,
    against the plain version window by window (:func:`whole_record_errors`).
    Returns the timings and launches, and the whole conservation on the
    host."""
    from memo_tpu_torch.index.store import COLUMNS, IntervalStore
    from memo_tpu_torch.ops.fused_query import fused_query_rows
    from memo_tpu_torch.ops.fused_query_v2 import fused_query_v2_rows
    from memo_tpu_torch.parallel import ResidentShardedQuery
    from memo_tpu_torch.query.window import window_params

    n = store.n_docs
    loaded = IntervalStore.load(npz)
    torch.cuda.reset_peak_memory_stats()
    fused_query_rows.launches = fused_query_v2_rows.launches = window_params.launches = 0
    with rss_peak() as host, numpy_array_reads(store.num_records + 1) as big:
        rq, place_s, stages = timed_stages(
            lambda: (ResidentShardedQuery(loaded, device, k_max=1024), sync(device))[0])
    host["rss_after_setup_bytes"] = rss_bytes()
    host["numpy_large_reads"] = len(big)
    setup_peak = torch.cuda.max_memory_allocated()
    steady = torch.cuda.memory_allocated()
    pads = pad_bytes(rq._placed())
    check(not big and loaded.file_columns()[1] == list(COLUMNS),
          f"resident set-up from {os.path.basename(npz)} read no column on the host")
    t0 = time.perf_counter()
    cons = rq.conservation_full(K)
    sync(device)
    cons_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    memb = rq.membership_full(K)
    sync(device)
    memb_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {"v1": fused_query_rows.launches, "v2": fused_query_v2_rows.launches,
                "window": window_params.launches}
    check(tuple(cons.shape) == (CHROM_LEN,) and tuple(memb.shape) == (CHROM_LEN, n),
          f"resident whole-record shapes {tuple(cons.shape)} {tuple(memb.shape)}")
    check(rq.dispatch_count == 2 and launches["v1"] > 0, f"resident dispatches: {launches}")
    for qs, qe in spots:
        check(np.array_equal(cons[qs:qe].cpu().numpy(), reference_query_np(store, qs, qe, K)),
              f"resident conservation spot {qs}-{qe} == reference loop")
    qs, qe = spots[-1]
    check(qs * n >= 1 << 31, "the membership spot lies past 2^31 output elements")
    check(np.array_equal(memb[qs:qe].cpu().numpy(), reference_membership_np(store, qs, qe, K)),
          f"resident membership spot {qs}-{qe} == reference loop")
    # Only bucket 0 marks at K, so its launch over the record's windows is
    # resident's whole output.
    live = [c for lb, c in (rq.engine._children or [(0, rq.engine)]) if lb < K - 1]
    check(len(live) == 1, f"one bucket marks at k={K}: {len(live)}")
    L = rq.engine.chunk_positions
    wins = [(qs, min(qs + L, CHROM_LEN)) for qs in range(0, CHROM_LEN, L)]
    errors = {mode: whole_record_errors(live[0], "chr1", wins, K, mode == "membership", out)
              for mode, out in (("conservation", cons), ("membership", memb))}
    del memb
    torch.cuda.empty_cache()
    functions = {f"{v}_{mode}": function_ms(live[0], "chr1", wins, K, v, mode == "membership")
                 for v in ("v1", "v2") for mode in ("conservation", "membership")}
    # stats() would read the columns on the host (rows_per_shard); its own keys here.
    placed = [(*c._d, *c._layout.device_tensors()) for c in rq._placed()]
    stats = {"local_rows": rq.local_rows, "slab_positions": rq.B, "placed_bytes":
             sum(t.numel() * t.element_size() for d in placed for t in d)}
    cons = cons.cpu().numpy()
    del rq, placed
    torch.cuda.empty_cache()
    return {"from": os.path.basename(npz), "place_s": place_s, "setup_stages": stages,
            "setup_host": host, "setup_peak_device_bytes": setup_peak,
            "steady_device_bytes": steady, "pad": pads,
            "rss_after_setup_bytes": host["rss_after_setup_bytes"],
            "columns_read_on_host": 0, "conservation_dispatch_s": cons_s,
            "membership_dispatch_s": memb_s,
            "peak_device_bytes": peak, "launches": launches, "stats": stats,
            "functions": functions, "spots_exact": len(spots),
            "membership_spot_past_2_31": True, "whole_record_windows": len(wins),
            "whole_record_max_abs_err": errors}, cons


def phase_chromosome(device, tmp: str):
    """SCALE_r05's configuration on one card: the 128 Mbp x 90 store, built
    here; the eight 2 Mbp windows through the stratified engine with v1 and
    with v2 (set-up stages and peak memory, walls, each function's time,
    spot windows past 100M against the reference loop); resident over the
    whole record, set up from the saved .npz without reading a column on
    the host (conservation and membership, one kernel launch per bucket);
    the CLI's ``-r`` on one window (stages, bytes) and ``--regions-file``
    with ``auto`` (resolved to resident), ``batched``, ``position`` and
    ``interval``, byte-identical, each with no column through numpy's
    reader (walls, host RSS, peak device bytes; position's and interval's
    stages); 1,400 gene windows as one ragged launch of each function
    (:func:`ragged_function`).
    Returns the kernel records (the genes batch's under ``genes``), each
    kernel's launches and its error over the whole record and the genes
    batch."""
    from memo_tpu_torch import cli
    from memo_tpu_torch.ops.fused_query import fused_query_rows
    from memo_tpu_torch.ops.fused_query_v2 import fused_query_v2_rows
    from memo_tpu_torch.query.engine import QueryEngine
    from memo_tpu_torch.query.output import format_conservation
    from memo_tpu_torch.query.window import window_params

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    store = build_chromosome_store(np.random.default_rng(SEED))
    build_s = time.perf_counter() - t0
    host = host_memory()
    n_rows = store.num_intervals
    check(abs(n_rows - CHROM_INTERVALS) <= CHROM_INTERVALS // 10,
          f"chromosome store: {n_rows} intervals, SCALE_r05's {CHROM_INTERVALS} +-10%")
    lengths = store.end - store.start
    edges = QueryEngine.STRATA_EDGES
    by_bucket = np.bincount(np.searchsorted(edges, lengths, side="right"), minlength=len(edges) + 1)
    long_rows = int((lengths >= 1023).sum())
    del lengths
    npz = os.path.join(tmp, "chrom.npz")
    t0 = time.perf_counter()
    store.save(npz, compressed=False)
    save_s = time.perf_counter() - t0

    wins = chromosome_windows()
    spots = [(wins[1][0] + 54_321, wins[1][0] + 54_321 + SPOT),
             (wins[6][0] + 777_777, wins[6][0] + 777_777 + SPOT)]
    check(spots[-1][0] > 100_000_000, "a spot window lies past position 100M")
    # Windows at the record's end and past it.
    edges = [(CHROM_LEN - 1000, CHROM_LEN), (CHROM_LEN - 7, CHROM_LEN + 5000),
             (CHROM_LEN, CHROM_LEN + 64), (CHROM_LEN + 100_000, CHROM_LEN + 100_001)]
    launches = {"v1": 0, "v2": 0, "window": 0}
    genes = gene_windows(np.random.default_rng(SEED), CHROM_LEN)
    gene_rows = gene_marking_rows(store, genes, K, device)
    torch.cuda.empty_cache()
    engines, outs, tiled, tiles_host, ragged = {}, None, {}, None, {}
    for version in ("v1", "v2"):
        torch.cuda.reset_peak_memory_stats()
        fused_query_rows.launches = fused_query_v2_rows.launches = 0
        eng, init_s, stages = timed_stages(lambda: QueryEngine(
            store, backend="fused", device=device, chunk_positions=CHROM_WINDOW,
            device_output=True, kernel_version=version))
        setup_peak = torch.cuda.max_memory_allocated()
        steady = torch.cuda.memory_allocated()
        rss = rss_bytes()
        check(eng._children is not None, "the chromosome store is stratified")
        if version == "v1":  # the card's window parameters of the shortest and longest rows
            params = {lb: params_check(c, "chr1", [wins] + [[w] for w in wins + edges + spots])
                      for lb, c in (eng._children[0], eng._children[-1])}
            for _, c in eng._children:
                _PLAIN.pop(c, None)
        window_params.launches = 0
        got = [eng.conservation("chr1", qs, qe, K).cpu().numpy() for qs, qe in wins]
        for qs, qe in spots:
            i = next(j for j, (ws, we) in enumerate(wins) if ws <= qs and qe <= we)
            check(np.array_equal(got[i][qs - wins[i][0]:qe - wins[i][0]],
                                 reference_query_np(store, qs, qe, K)),
                  f"chromosome {version} spot {qs}-{qe} == reference loop")
        if outs is None:
            outs = got
        else:
            check(all(np.array_equal(a, b) for a, b in zip(outs, got)), "v2 windows == v1 windows")
        walls, rows = [], []
        for qs, qe in wins:
            walls.append(wall_median_s(lambda: eng.conservation("chr1", qs, qe, K), device,
                                       reps=CHROM_REPS))
            rows.append(eng.last_stats.candidate_intervals)
        chunked = chunked_query(eng, device)
        tiled[version], tiles = tile_batch(eng, device, store, wins, outs)
        if tiles_host is None:
            tiles_host = tiles
        else:
            check(np.array_equal(tiles, tiles_host), "v2's tiles == v1's")
        del tiles
        if version == "v1":  # k=51: buckets 0 and 32 live, whole, with no read or wait
            no_wait = no_wait_query(eng, "chr1", *wins[3], 51, plain=True)
            check(len(no_wait["candidates_by_bucket"]) == 2, "two buckets live at k=51")
        launches[version] += (fused_query_rows.launches if version == "v1"
                              else fused_query_v2_rows.launches)
        launches["window"] += window_params.launches
        child = eng._children[0][1]  # the only bucket that marks at K
        functions = [time_function(child, "chr1", [w], K, version) for w in wins]
        ragged[version] = ragged_function(child, "chr1", genes, K, version, gene_rows)
        launches[version] += ragged[version]["launches"]
        if version == "v1":
            window_fn = time_window_params(child, "chr1", [wins[3]], K)
        engines[version] = {"engine_init_s": init_s, "engine_init_stages": stages,
                            "setup_peak_device_bytes": setup_peak,
                            "steady_device_bytes": steady, "pad": pad_bytes(
                                [c for _, c in eng._children]),
                            "rss_after_setup_bytes": rss,
                            "buckets": [(lb, c._layout.num_rows) for lb, c in eng._children],
                            "window_wall_ms": [w * 1e3 for w in walls],
                            "window_mbp_s": [CHROM_WINDOW / w / 1e6 for w in walls],
                            "candidate_rows": rows, "chunked_query": chunked,
                            "functions": functions}
        del eng, child
        torch.cuda.empty_cache()

    resident, cons = resident_whole_record(store, npz, device, spots)
    launches["v1"] += resident["launches"]["v1"]
    launches["window"] += resident["launches"]["window"]
    for (qs, qe), out in zip(wins, outs):
        check(np.array_equal(cons[qs:qe], out), f"resident window {qs}-{qe} == the engine's")
    check(np.array_equal(cons, tiles_host), "the 128,000 tiles == resident's whole record")
    del cons, tiles_host
    torch.cuda.empty_cache()
    streamed = streamed_columns_check(store, npz, device)
    R = store.num_records
    del store
    torch.cuda.empty_cache()

    q = 3  # the CLI -r window
    cli_out = os.path.join(tmp, "chrom_cons.txt")
    fused_query_rows.launches = window_params.launches = 0
    rc, cli_s, cli_stages, cli_host = timed_cli(
        ["query", "-b", npz, "-k", str(K), "-r", f"chr1:{wins[q][0]}-{wins[q][1]}", "-o", cli_out,
         "--device", device.type], R + 1)
    check(rc == 0 and fused_query_rows.launches > 0 and window_params.launches > 0,
          "chromosome CLI -r ran the window and v1 kernels")
    check_streamed(cli_stages, cli_host, "chromosome CLI -r (stored .npz)")
    launches["v1"] += fused_query_rows.launches
    launches["window"] += window_params.launches
    with open(cli_out, "rb") as fh:
        check(fh.read() == format_conservation(outs[q]), "chromosome CLI -r bytes == the engine's")
    regions = os.path.join(tmp, "chrom_regions.txt")
    with open(regions, "w") as fh:
        fh.writelines(f"chr1:{qs}-{qe}\n" for qs, qe in wins)
    records: list[str] = []
    handler = logging.Handler()
    handler.emit = lambda rec: records.append(rec.getMessage())
    cli.log.addHandler(handler)
    regions_s, regions_host, regions_stages, regions_peak = {}, {}, {}, {}
    strategies = ("auto", "batched", "position", "interval")
    try:
        for strategy in strategies:
            fused_query_rows.launches = window_params.launches = 0
            torch.cuda.reset_peak_memory_stats()
            rc, regions_s[strategy], regions_stages[strategy], regions_host[strategy] = timed_cli(
                ["query", "-b", npz, "-k", str(K), "--regions-file", regions, "-o",
                 os.path.join(tmp, f"chrom_{strategy}"), "--strategy", strategy,
                 "--device", device.type], R + 1)
            regions_peak[strategy] = torch.cuda.max_memory_allocated()
            check(rc == 0, f"chromosome --regions-file {strategy} exit code {rc}")
            if strategy in ("auto", "batched"):  # position and interval run the torch ops
                check(fused_query_rows.launches > 0,
                      f"chromosome --regions-file {strategy} ran the v1 kernel")
            check(regions_host[strategy]["numpy_large_reads"] == 0,
                  f"chromosome --regions-file {strategy}: no column through numpy's reader")
            launches["v1"] += fused_query_rows.launches
            launches["window"] += window_params.launches
    finally:
        cli.log.removeHandler(handler)
    check("--strategy auto resolved to 'resident'" in records, f"auto resolved to resident: {records}")
    for (qs, qe), out in zip(wins, outs):
        name = f"chr1_{qs}_{qe}.txt"
        want = format_conservation(out)
        for strategy in strategies:
            with open(os.path.join(tmp, f"chrom_{strategy}.{name}"), "rb") as fh:
                check(fh.read() == want,
                      f"--regions-file {strategy} == batched == the engine's bytes, {name}")
    os.remove(npz)
    emit("phase12_chromosome", L=CHROM_LEN, n_docs=CHROM_DOCS, k=K, gap=CHROM_GAP,
         intervals=n_rows, scale_r05_intervals=CHROM_INTERVALS, bucket_rows=by_bucket.tolist(),
         rows_ge_k_max=long_rows, store_build_s=build_s, store_save_s=save_s, **host,
         windows=wins, spot_windows=spots, edge_windows=edges, window_params_vs_numpy=params,
         engines=engines, resident=resident,
         cli_r_window=list(wins[q]), cli_query_s=cli_s, cli_stages_s=cli_stages,
         cli_host=cli_host, streamed_columns=streamed, cli_bytes_equal=True,
         regions_cli_s=regions_s, regions_cli_host=regions_host,
         regions_cli_stages_s={k: v for k, v in regions_stages.items()
                               if k in ("position", "interval")},
         regions_cli_peak_device_bytes=regions_peak, auto_resolved="resident",
         regions_byte_identical=True, launches=launches, window_kernel=window_fn,
         no_wait_query_k51=no_wait, tile_batch=tiled, tiles_equal_resident=True,
         gene_batch=ragged)
    whole = resident["whole_record_max_abs_err"].values()
    return ({v: engines[v]["functions"][q] for v in ("v1", "v2")}
            | {"window": window_fn, "genes": ragged}, launches,
            {v: max(ragged[v]["max_abs_err"], *(errors[v] for errors in whole))
             for v in ("v1", "v2")})


def headline_device_ms(eng, record: str, wins) -> dict:
    """The kernels' device times (CUDA events) at the headline, for an A/B
    of two trees: the window step of one window and of the batch, and the
    v1 and v2 functions on each."""
    out = {}
    for name, windows in (("window", [(0, PIVOT_LEN)]), ("batch", wins)):
        L = max(qe - qs for qs, qe in windows)
        starts = [qs for qs, _ in windows]
        wp = eng._window_params(record, starts, L, K)
        C = eng.n_docs
        out[name] = {"window_step_ms": kernel_ms(lambda: eng._window_params(record, starts, L, K))}
        for version, fn in kernel_functions().items():
            out[name][f"{version}_function_ms"] = kernel_ms(lambda: fn(
                eng._d, wp.params, wp.prefix, k=K, L=L, C=C, n_docs=C, membership=False))
    return out


def setup_cells(tmp: str) -> int:
    """The set-up cells, measured on the ``memo_tpu_torch`` beside this
    file (so a copy of this script in another tree measures that tree's):
    the headline single-window query wall (fused, result on the card,
    median of WALL_REPS with its spread), the 16 x 1 Mbp batch's wall and
    the kernels' device times there (:func:`headline_device_ms`), and
    resident's dispatch of that batch to the host and on the card, set up
    from ``tmp``/headline.npz (:func:`resident_dispatch`), and the batch
    through every strategy in process from that file (:func:`mesh_walls`:
    placement, dispatch and position's and interval's ops apart); n90's
    stratified engine, from ``tmp``/n90.npz, across K_SWEEP
    (:func:`k_sweep`); and at the chromosome scale, its
    store loaded from ``tmp``/chrom.npz (built from the seed and saved there
    by the first run), the stratified engine's set-up with its stages, host
    RSS before and after it, set-up peak and steady device bytes, and the
    wall of a query of eight position chunks (:func:`chunked_query`);
    ResidentShardedQuery's placement from the loaded store, the same, with
    its host RSS peak, numpy's large reads and the columns it read on the
    host, and again from the store with its columns read into memory; the
    CLI ``-r`` of window 3 with its stages and host memory; the CLI
    ``--regions-file`` of the eight 2 Mbp windows with ``auto``
    (resident), the same, and with ``position`` and ``interval`` (their
    peak device bytes too, and bytes == auto's); the CLI ``-r`` of the n=90 store's whole window
    from ``tmp``/n90.npz (stored members) and
    ``tmp``/n90_deflated.npz (the default ``save()``, the file ``memo
    index`` writes), byte-identical; and how numpy's load of the chromosome
    and of the deflated n=90 file splits on this host (:func:`load_split`).
    Prints one line, ``setup_cells {...}``."""
    from memo_tpu_torch.index.store import COLUMNS, IntervalStore
    from memo_tpu_torch.parallel import Mesh, ResidentShardedQuery
    from memo_tpu_torch.query.engine import QueryEngine

    device = torch.device("cuda")
    card = gpu_name_and_power()
    store = build_store(np.random.default_rng(SEED))
    eng = QueryEngine(store, backend="fused", device=device, chunk_positions=PIVOT_LEN,
                      device_output=True)
    headline = spread_ms(walls_s(lambda: eng.conservation("chr1", 0, PIVOT_LEN, K), device))
    wins = batch_windows(PIVOT_LEN)
    batch = spread_ms(walls_s(lambda: eng.conservation_batch("chr1", wins, K), device))
    kernels = headline_device_ms(eng, "chr1", wins)
    singles = [eng.conservation("chr1", qs, qe, K).cpu().numpy() for qs, qe in wins]
    del eng
    os.makedirs(tmp, exist_ok=True)
    headline_npz = os.path.join(tmp, "headline.npz")
    store.save(headline_npz, compressed=False)
    dispatch = resident_dispatch(headline_npz, device, wins, singles)
    del store
    torch.cuda.empty_cache()
    sharded = mesh_walls(IntervalStore.load(headline_npz), Mesh(1, 1, device), singles)
    torch.cuda.empty_cache()

    npz = os.path.join(tmp, "chrom.npz")
    n90 = {"stored": os.path.join(tmp, "n90.npz"), "deflated": os.path.join(tmp, "n90_deflated.npz")}
    if not os.path.exists(npz):
        build_chromosome_store(np.random.default_rng(SEED)).save(npz, compressed=False)
    if not all(map(os.path.exists, n90.values())):
        large = build_large_store(np.random.default_rng(SEED))
        large.save(n90["stored"], compressed=False)
        large.save(n90["deflated"])
        del large
    n90_store = IntervalStore.load(n90["stored"])
    eng = QueryEngine(n90_store, backend="fused", device=device, chunk_positions=LARGE_PIVOT_LEN,
                      max_intervals_per_chunk=1 << 25, device_output=True)
    n90_sweep = k_sweep(eng, "chr1", LARGE_PIVOT_LEN, device, reps=WALL_REPS)
    del eng, n90_store
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    store = IntervalStore.load(npz)
    load_s = time.perf_counter() - t0

    def measured(make, then=None) -> dict:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with rss_peak() as host, numpy_array_reads(2) as big:
            obj, wall, stages = timed_stages(lambda: (make(), sync(device))[0])
        out = {"s": wall, "stages": stages, "setup_peak_device_bytes":
               torch.cuda.max_memory_allocated(), "steady_device_bytes":
               torch.cuda.memory_allocated(), "rss_before_bytes": host["rss_before_bytes"],
               "rss_peak_bytes": host["rss_peak_bytes"], "rss_after_setup_bytes": rss_bytes(),
               "numpy_large_reads": len(big)}
        if then is not None:
            out |= then(obj)
        del obj
        return out

    engine = measured(lambda: QueryEngine(store, backend="fused", device=device,
                                          chunk_positions=CHROM_WINDOW, device_output=True),
                      lambda eng: {"chunked_query": chunked_query(eng, device, False),
                                   "pad": pad_bytes([c for _, c in eng._children])})
    resident = measured(lambda: ResidentShardedQuery(store, device, k_max=1024),
                        lambda rq: {"pad": pad_bytes(rq._placed())})
    resident["columns_read_on_host"] = 4 - len(store.file_columns()[1])
    for name in COLUMNS:  # the store in memory: every column read on the host
        getattr(store, name)
    resident_in_memory = measured(lambda: ResidentShardedQuery(store, device, k_max=1024))
    del store
    torch.cuda.empty_cache()
    qs, qe = chromosome_windows()[3]
    rc, cli_s, cli_stages, cli_host = timed_cli(
        ["query", "-b", npz, "-k", str(K), "-r", f"chr1:{qs}-{qe}", "-o",
         os.path.join(tmp, "cli_r.txt"), "--device", "cuda"], 2)
    check(rc == 0, "setup cells: CLI -r exit code")
    regions = os.path.join(tmp, "chrom_regions.txt")
    with open(regions, "w") as fh:
        fh.writelines(f"chr1:{a}-{b}\n" for a, b in chromosome_windows())
    torch.cuda.empty_cache()
    rc, regions_s, regions_stages, regions_host = timed_cli(
        ["query", "-b", npz, "-k", str(K), "--regions-file", regions, "-o",
         os.path.join(tmp, "chrom_auto"), "--strategy", "auto", "--device", "cuda"], 2)
    check(rc == 0, "setup cells: CLI --regions-file auto exit code")
    regions_sharded = {}
    for strategy in ("position", "interval"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rc, wall, stages, host = timed_cli(
            ["query", "-b", npz, "-k", str(K), "--regions-file", regions, "-o",
             os.path.join(tmp, f"chrom_{strategy}"), "--strategy", strategy, "--device", "cuda"],
            2)
        check(rc == 0, f"setup cells: CLI --regions-file {strategy} exit code")
        regions_sharded[strategy] = {"s": wall, "stages": stages, "host": host,
                                     "peak_device_bytes": torch.cuda.max_memory_allocated()}
        for a, b in chromosome_windows():
            name = f"chr1_{a}_{b}.txt"
            with open(os.path.join(tmp, f"chrom_auto.{name}"), "rb") as want, \
                    open(os.path.join(tmp, f"chrom_{strategy}.{name}"), "rb") as got:
                check(got.read() == want.read(), f"setup cells: {strategy} {name} == auto's")
    n90_cli = {}
    for kind, path in n90.items():
        torch.cuda.empty_cache()
        rc, wall, stages, host = timed_cli(
            ["query", "-b", path, "-k", str(K), "-r", f"chr1:0-{LARGE_PIVOT_LEN}", "-o",
             os.path.join(tmp, f"n90_{kind}.txt"), "--device", "cuda"], 2)
        check(rc == 0, f"setup cells: n90 {kind} CLI -r exit code")
        n90_cli[kind] = {"s": wall, "stages": stages, "host": host}
    with open(os.path.join(tmp, "n90_stored.txt"), "rb") as a, \
            open(os.path.join(tmp, "n90_deflated.txt"), "rb") as b:
        check(a.read() == b.read(), "setup cells: n90 CLI -r bytes, stored == deflated")
    split = {"chromosome": load_split(npz, device), "n90_deflated": load_split(n90["deflated"], device)}
    emit("setup_cells", card=card, tree=os.path.dirname(os.path.abspath(__file__)),
         headline_query_wall_ms=headline, batch_wall_ms=batch, headline_device_ms=kernels,
         n90_k_sweep=n90_sweep, chrom_load_s=load_s, engine=engine,
         headline_resident_dispatch=dispatch, resident=resident,
         resident_in_memory=resident_in_memory, regions_auto_s=regions_s,
         regions_auto_stages=regions_stages, regions_auto_host=regions_host,
         headline_sharded=sharded, regions_sharded=regions_sharded, cli_r_s=cli_s,
         cli_r_stages=cli_stages, cli_r_host=cli_host,
         n90_cli_r=n90_cli, n90_bytes_equal=True, load_split=split)
    return 0


WINDOW_KEYS = ("windows", "C", "record_rows", "ms", "plain_ms", "kernel_us",
               "wall_with_count_read_ms", "plain_wall_with_count_read_ms", "host_search_wall_ms",
               "bytes", "bound_ms", "bound_share")
FUNCTION_KEYS = ("C", "L", "windows", "candidate_rows", "tile", "ms", "plain_ms", "bytes",
                 "bound_ms", "bound_share", "kernels_us")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke needs a CUDA device",
              file=sys.stderr)
        return 1
    device = torch.device("cuda")
    card = phase_env()
    phase_build()
    phase_entry(device)
    kernel_err = phase_kernels(device)
    with tempfile.TemporaryDirectory() as tmp:
        launches, head, head_v2, head_window, store, mbp_s = phase_headline(device, tmp)
        singles, batch = phase_batched(device, store)
        del store
        v2_launches = phase_cli_regions(device, tmp, singles, mbp_s["torch"])
        large = phase_hprc(device, tmp)
        wide = phase_full_width(device, large)
        del large
        c1000 = phase_wide(device, card)
        phase_membership(device)
        phase_mesh(tmp, singles)
        chrom, chrom_launches, chrom_err = phase_chromosome(device, tmp)
    cells = {"v1": {"headline": head, "batch": batch["v1"]},
             "v2": {"headline": head_v2, "batch": batch["v2"]}}
    for name in ("n90", "n160", "dense_small"):
        cells["v1"][name] = wide[name]["kernel_v1"]
        cells["v2"][name] = wide[name]["kernel_v2"]
    for version in ("v1", "v2"):
        cells[version]["chromosome"] = chrom[version]
        cells[version]["genes"] = chrom["genes"][version]
    for version in ("v1", "v2"):
        emit(f"{version}_function", card=card, **{name: {key: cell[key] for key in FUNCTION_KEYS}
                                                  for name, cell in cells[version].items()})
    windows = {"headline": head_window, "batch": batch["window"], "chromosome": chrom["window"]}
    emit("window_function", card=card, checks=WINDOW_CHECKS,
         **{name: {key: cell[key] for key in WINDOW_KEYS} for name, cell in windows.items()})
    print(json.dumps({"kernels": [{
        "name": "fused_query_rows",
        "route": "cuda",
        "source": "memo_tpu_torch/csrc/fused_query.cu",
        "replaces": "memo_tpu/ops/pallas_query.py:236",
        "launches": launches["v1"] + chrom_launches["v1"] + c1000["engines"]["v1"]["launches"],
        "max_abs_err": max(kernel_err["v1"], chrom_err["v1"],
                           *(c["max_abs_err"] for c in cells["v1"].values()),
                           *(f["max_abs_err"] for f in c1000["functions"].values()
                             if f["version"] == "v1")),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": None,
    }, {
        "name": "fused_query_v2_rows",
        "route": "cuda",
        "source": "memo_tpu_torch/csrc/fused_query_v2.cu",
        "replaces": "memo_tpu/ops/pallas_query_v2.py:301",
        "launches": v2_launches + chrom_launches["v2"] + c1000["engines"]["v2"]["launches"],
        "max_abs_err": max(kernel_err["v2"], chrom_err["v2"],
                           *(c["max_abs_err"] for c in cells["v2"].values()),
                           *(f["max_abs_err"] for f in c1000["functions"].values()
                             if f["version"] == "v2")),
        "ms": head_v2["ms"],
        "plain_ms": head_v2["plain_ms"],
        "bound_ms": head_v2["bound_ms"],
        "bound_by": head_v2["bound_by"],
        "library_ms": None,
    }, {
        "name": "window_params",
        "route": "cuda",
        "source": "memo_tpu_torch/csrc/window_params.cu",
        # No TPU kernel: memo_tpu searches the host (engine.py:385-400).
        "replaces": "memo_tpu/query/engine.py:385",
        "launches": launches["window"] + chrom_launches["window"]
        + sum(e["window_launches"] for e in c1000["engines"].values()),
        "max_abs_err": WINDOW_CHECKS["max_abs_err"],
        "ms": head_window["ms"],
        "plain_ms": head_window["plain_ms"],
        "bound_ms": head_window["bound_ms"],
        "bound_by": head_window["bound_by"],
        "library_ms": None,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


def dense_function_main() -> int:
    """``--dense-function``: the v1 and v2 functions on dense_small's
    bucket-0 window (as phase 8 runs them), on the ``memo_tpu_torch`` beside
    this file (so a copy of this script in another tree measures that
    tree's), each exact against the plain version, then DENSE_ROUNDS
    rounds, v1 and v2 in turn: the function's device time by CUDA events
    over KERNEL_REPS back-to-back calls (:func:`kernel_ms`) and each of its
    kernels' device time from one profiler trace (:func:`device_ops`), so
    that a slower call with the same kernel times is told apart as host
    time. Prints one line, ``dense_function {...}``, beside the card."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from memo_tpu_torch.index.builder import store_from_ms
    from memo_tpu_torch.query.engine import QueryEngine

    device = torch.device("cuda")
    ms = synth_ms(np.random.default_rng(SEED), DENSE_LEN, DENSE_DOCS - 1, K, gap=25)
    store = store_from_ms([ms], ["chr1"], [DENSE_LEN], DENSE_DOCS, "conservation")
    del ms
    eng = QueryEngine(store, backend="fused", device=device, chunk_positions=DENSE_LEN,
                      max_intervals_per_chunk=1 << 25, device_output=True, kernel_version="v2")
    child = eng._children[0][1] if eng._children else eng
    fns = kernel_functions()
    exact = kernel_case(child, "chr1", [(0, DENSE_LEN)], K, False, fns)
    wp, L = v1_inputs(child, "chr1", [(0, DENSE_LEN)], K)
    C = child.n_docs
    out = {version: {"ms": [], "kernels_us": []} for version in fns}
    for _ in range(DENSE_ROUNDS):
        for version, fn in fns.items():
            def run(fn=fn):
                return fn(child._d, wp.params, wp.prefix, k=K, L=L, C=C, n_docs=C,
                          membership=False)

            out[version]["ms"].append(kernel_ms(run))
            out[version]["kernels_us"].append(
                device_ops(run, kernels_of(version, C, 1, L)))
    emit("dense_function", tree=os.path.dirname(os.path.abspath(__file__)),
         card=gpu_name_and_power(), L=L, C=C, candidate_rows=int(wp.counts.sum()),
         max_abs_err=exact, rounds=DENSE_ROUNDS, reps=KERNEL_REPS, **out)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [MESH_CHILD]:
        raise SystemExit(mesh_child(sys.argv[2]))
    if sys.argv[1:2] == [SETUP_CELLS]:
        raise SystemExit(setup_cells(sys.argv[2]))
    if sys.argv[1:2] == [DENSE_FUNCTION]:
        raise SystemExit(dense_function_main())
    raise SystemExit(main())
