"""One run of one cell of the port's benchmark.

A cell (``BENCHMARK.json`` ``workloads``) names a configuration and a
traffic mix; everything of either is found by name, so a new cell needs new
files and entries only:

- the configuration: the JSON file its entry names, whose ``generator``
  (``gen/<name>.py``) makes the index's interval columns from the seed and
  whose ``reference`` (``reference/<name>.py``, a ``Reference(inputs,
  device)`` with ``answer`` and ``control``) is the plain answer the outputs
  are held to;
- the traffic mix: ``traffic/<name>.json``, whose ``driver``
  (``drivers/<name>.py``) turns its parameters into the seed's requests and
  hands each to the program;
- each metric: ``metrics/<name>.py``, or ``metrics/<name up to its first
  dot>.py`` for a reader that several metrics share, whose ``read(run)``
  gives its value or None where the run has nothing for it to read.

A run: make the inputs on the device from the seed; build the program's
``QueryEngine`` over them; warm up the traffic's shapes, then run the
traffic's own requests for ``WARM_SECONDS`` and discard them; then one client
sends the mix's requests in a closed loop for ``seconds`` (``--trace 1``:
the first ``TRACE_SECONDS`` under ``torch.profiler``); then, with the
program's state freed, a sample of the answers drawn from the seed, with
the longest, is held to the reference. The last line of standard output is
the result; the numbers compared, each beside its limit, are the last lines
of standard error and the result's last key.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import importlib.util
import json
import math
import pathlib
import resource
import sys
import time
import traceback

import numpy as np
import torch

from portbench import trace as tracing
from portbench import work

TRACE_SECONDS = 2.0  # the traced stretch at the start of a --trace 1 window
WARM_SECONDS = 1.0  # the cell's own traffic, run and discarded before the window (set-up)
FORBIDDEN = ("jax", "jaxlib", "flax", "memo_tpu", "bench")  # top-level names no run may load


def log(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # the BENCHMARK.json entries of the metrics this cell reports
    per_layer: list


def _for_cell(metrics: list, name: str) -> list:
    return [m for m in metrics if name in m.get("workloads", [name])]


def load_cell(root: pathlib.Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, with its configuration
    and traffic files read."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    workload = next((w for w in bench["workloads"] if w["name"] == name), None)
    if workload is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == workload["config"])
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic" / f"{workload['traffic']}.json").read_text())
    return Cell(name, int(workload["chips"]), config, traffic,
                _for_cell(bench["end_to_end"], name), _for_cell(bench["per_layer"], name))


def plugin(root: pathlib.Path, folder: str, name: str):
    """The module ``root/portbench/<folder>/<name>.py``, or where there is
    none, the one named by ``name`` up to its first dot: metrics that read
    one quantity in cells of different end-to-end metrics
    (``kernels_roofline.query``, ``kernels_roofline.regions``) share one
    reader (``metrics/kernels_roofline.py``)."""
    path = root / "portbench" / folder / f"{name}.py"
    if not path.exists():
        path = path.with_name(f"{name.split('.')[0]}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_{folder}_{name}".replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Done:
    """A request of the window: when it was issued and returned (host
    clock), and whether it raised."""

    windows: list
    k: int
    t0: float
    t1: float
    failed: bool

    @property
    def positions(self) -> int:
        return sum(qe - qs for qs, qe in self.windows)


class Sampler:
    """A uniform sample of ``size`` requests of the window, and the request
    with the longest window. Which request takes which slot is drawn from
    the seed before the window (reservoir sampling with skips, Li's
    algorithm L, over requests 0, 1, ...), so keeping a request in the
    window is one look-up. Kept answers are held as the program returned
    them, never copied; an answer that leaves the sample is freed, as every
    answer the sample does not take is."""

    HORIZON = 1 << 40  # requests the plan covers

    def __init__(self, size: int, seed: int):
        self.size = int(size)
        self.plan = self._plan(self.size, np.random.default_rng([seed, 2]))
        self.slots: list = [None] * self.size
        self.longest = None  # (length, item)

    @classmethod
    def _plan(cls, size: int, rng) -> dict[int, int]:
        """{request index: slot}: the reservoir's replacements, in order."""
        plan = {i: i for i in range(size)}
        if not size:
            return plan
        def u() -> float:  # uniform on (0, 1]
            return 1.0 - rng.random()

        w, i = math.exp(math.log(u()) / size), size - 1
        while 0.0 < w < 1.0:
            i += int(math.log(u()) / math.log1p(-w)) + 1
            if i >= cls.HORIZON:
                break
            plan[i] = int(rng.integers(size))
            w *= math.exp(math.log(u()) / size)
        return plan

    def offer(self, index: int, windows: list, k: int, answers: list) -> None:
        item = (index, windows, k, answers)
        slot = self.plan.get(index)
        if slot is not None:
            self.slots[slot] = item
        longest = max(qe - qs for qs, qe in windows)
        if self.longest is None or longest > self.longest[0]:
            self.longest = (longest, item)

    def items(self) -> list:
        """(qs, qe, k, answer) of every window of the kept requests."""
        kept = {item[0]: item for item in self.slots if item is not None}
        if self.longest is not None:
            kept[self.longest[1][0]] = self.longest[1]
        return [(qs, qe, k, answer) for _, (_, windows, k, answers) in sorted(kept.items())
                for (qs, qe), answer in zip(windows, answers)]


@dataclasses.dataclass
class Run:
    """What a run recorded, for the metric readers."""

    cell: Cell
    inputs: object
    kind: str
    device: torch.device
    setup_s: float
    engine_init_s: float
    done: list
    window_s: float
    trace: tracing.Trace | None
    traced: int

    @functools.cached_property
    def traced_work(self) -> tuple[int, int]:
        """The least work of the traced requests: (marking rows, positions)."""
        reqs = self.done[: self.traced]
        windows = [(qs, qe, d.k) for d in reqs for qs, qe in d.windows]
        rows = work.marking_rows(self.inputs.start, self.inputs.end, windows, self.device)
        return int(rows.sum()), sum(d.positions for d in reqs)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _cpu_s() -> float:
    """CPU seconds this process has used so far, all its threads."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def _window_host(cpu_s: float, done: list, t_begin: float) -> dict:
    """The process's CPU seconds in the window, and the Mbp answered in
    each whole second of it, to tell a slow stretch from a slow run."""
    mbp = collections.Counter()
    for d in done:
        mbp[int(d.t1 - t_begin)] += d.positions * 1e-6
    return {"cpu_s": cpu_s,
            "mbp_by_second": [round(mbp[i], 3) for i in range(max(mbp, default=-1) + 1)]}


def _window(engine, issue, record, stream, seconds, sampler, device, profile_s):
    """The timed window: one client sends ``stream``'s requests until
    ``seconds`` have passed, the first ``profile_s`` of them under
    torch.profiler. Returns the requests done, the window's seconds (first
    issue to last return), the profile or None, how many requests it
    traced, and the window's start."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    prof = None
    if profile_s:
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
    tracing_on, traced, done = prof is not None, 0, []
    t_begin = time.perf_counter()

    def note(name: str):
        return record_function(name) if tracing_on else contextlib.nullcontext()

    while True:
        with note("portbench.next"):
            req = next(stream)
        failed, answers = False, []
        t0 = time.perf_counter()
        try:
            with note(tracing.ANNOTATION):
                answers = issue(engine, record, req)
        except Exception:  # a request that raises is counted as failed; the loop goes on
            failed = True
            if not any(d.failed for d in done):
                log(traceback.format_exc())
        t1 = time.perf_counter()
        done.append(Done(req.windows, req.k, t0, t1, failed))
        traced += tracing_on
        with note("portbench.sample"):
            if not failed:
                sampler.offer(len(done) - 1, req.windows, req.k, answers)
        with note("portbench.release"):  # the answers not sampled are freed
            del answers
        if tracing_on and t1 - t_begin >= profile_s:
            _sync(device)
            prof.__exit__(None, None, None)
            tracing_on = False
        if t1 - t_begin >= seconds:
            break
    if tracing_on:
        prof.__exit__(None, None, None)
    return done, done[-1].t1 - t_begin, prof, traced, t_begin


def check(reference, items: list, failed: int) -> dict:
    """The numbers compared, each with its limit: positions whose answer
    differs from the reference's (a wrong length counts every position),
    requests that raised, and windows checked."""
    mismatched = 0
    for qs, qe, k, got in items:
        want = reference.answer(qs, qe, k)
        if np.shape(got) != want.shape:
            mismatched += want.size
        else:
            mismatched += int(np.count_nonzero(np.asarray(got) != want))
    return {"mismatched_positions": {"value": mismatched, "limit": 0, "must_be": "<="},
            "failed_requests": {"value": failed, "limit": 0, "must_be": "<="},
            "windows_checked": {"value": len(items), "limit": 1, "must_be": ">="}}


def _passes(number: dict) -> bool:
    v, lim = number["value"], number["limit"]
    return v <= lim if number["must_be"] == "<=" else v >= lim


def run_cell(root: pathlib.Path, name: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, control: bool = False) -> dict:
    """One run of cell ``name`` on ``device``; the result line's object.
    With ``control``, also ``"control"``: the same numbers for the
    reference's control put in the program's place, on the same sample."""
    from memo_tpu_torch import IntervalStore, QueryEngine
    from memo_tpu_torch.utils.profiling import GLOBAL_TIMES

    cell = load_cell(root, name)
    cfg, traffic = cell.config, cell.traffic
    gen = plugin(root, "gen", cfg["generator"])
    reference = plugin(root, "reference", cfg["reference"])
    driver = plugin(root, "drivers", traffic["driver"])
    device = torch.device(device)
    stages = {"start": time.perf_counter() - t_start}  # the interpreter, torch and the program imported

    t = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=device)
        kind = torch.cuda.get_device_name(device)
    else:
        kind = "cpu"
    stages["device_init"] = time.perf_counter() - t

    t = time.perf_counter()
    inputs = gen.generate(cfg, seed, device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    stages["generate"] = time.perf_counter() - t
    log(f"inputs {json.dumps({'rows': int(inputs.start.size), 'record_len': inputs.length, 'n_docs': inputs.n_docs, 'longest': inputs.longest})}")

    GLOBAL_TIMES.times.clear()
    t = time.perf_counter()
    store = IntervalStore(record_names=[inputs.record], record_lens=[inputs.length],
                          n_docs=inputs.n_docs, kind=cfg["kind"],
                          rec_id=np.zeros(inputs.start.size, np.int32), start=inputs.start,
                          end=inputs.end, order=inputs.order,
                          rec_offsets=[0, inputs.start.size], max_interval_len=[inputs.longest])
    engine = QueryEngine(store, device=device)
    _sync(device)
    engine_init_s = time.perf_counter() - t
    stages["engine_init"] = engine_init_s
    log(f"engine_stages {json.dumps(GLOBAL_TIMES.times)}")

    t = time.perf_counter()
    for req in driver.warmup(traffic, inputs.length, seed):
        driver.issue(engine, inputs.record, req)
    _sync(device)
    stages["warmup"] = time.perf_counter() - t

    t = time.perf_counter()
    warm = driver.stream(traffic, inputs.length, [seed, 3])
    while time.perf_counter() - t < WARM_SECONDS:
        driver.issue(engine, inputs.record, next(warm))
    _sync(device)
    stages["warm_stretch"] = time.perf_counter() - t

    sampler = Sampler(traffic["sample"], seed)
    stream = driver.stream(traffic, inputs.length, seed)
    cpu_s = _cpu_s()
    done, window_s, prof, traced, t_begin = _window(
        engine, driver.issue, inputs.record, stream, seconds, sampler, device,
        min(TRACE_SECONDS, seconds) if trace else 0.0)
    log(f"window_host {json.dumps(_window_host(_cpu_s() - cpu_s, done, t_begin))}")
    stages["setup"] = setup_s = t_begin - t_start
    log(f"setup {json.dumps(stages)}")

    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    del engine, store
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    failed = sum(d.failed for d in done)
    trace_obj = tracing.Trace(prof.events()) if prof is not None else None
    run = Run(cell, inputs, kind, device, setup_s, engine_init_s, done, window_s, trace_obj, traced)
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = plugin(root, "metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    t = time.perf_counter()
    items = sampler.items()
    ref = reference.Reference(inputs, device)
    numbers = check(ref, items, failed)
    log(f"checked {json.dumps({'windows': len(items), 'positions': sum(a.size for *_, a in items), 'reference_s': time.perf_counter() - t, 'host_rss_peak_bytes': resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024})}")

    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": all(_passes(n) for n in numbers.values()), "attempted": len(done),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace_obj is not None:
        dev["busy_s"] = trace_obj.busy_us() * 1e-6
        dev["window_s"] = trace_obj.window_us() * 1e-6
        result["breakdown"] = trace_obj.breakdown()
    if control:
        in_place = [(qs, qe, k, ref.control(qs, qe, k)) for qs, qe, k, _ in items]
        result["control"] = check(ref, in_place, 0)
    result["checks"] = numbers
    return result


def card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess

    try:
        got = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read: {e}"
    return got.stdout.strip() or got.stderr.strip()


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one no run may load."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv: list[str], t_start: float, root: pathlib.Path) -> int:
    import argparse

    p = argparse.ArgumentParser(description="One run of one cell of the port's benchmark.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    chips = load_cell(root, args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    log(f"card {card()}")
    loaded = forbidden_modules()
    if loaded:
        log(f"modules no run may load were loaded: {loaded}")
        return 3
    for key, number in result["checks"].items():
        log(f"check {key} {number['value']} {number['must_be']} {number['limit']}")
    print(json.dumps(result), flush=True)
    return 0
