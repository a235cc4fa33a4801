"""The query path's spans and counters (``memo_tpu_torch.utils.profiling``),
on the CPU under ``torch.profiler``.

While a profiler records, the engine opens its spans (``memo.query``,
``memo.batch``, ``memo.window_step``, ``memo.launch``, ``memo.join``,
``memo.copy_back``, ``memo.views``), each a CPU operation inside its caller's
span and never a user annotation, and counts the positions it launches,
the bytes it brings to the host and the candidate rows it hands the
kernels. Without a profiler the counters stay empty and the outputs are
the same bytes. The stage timers open their stage's span, and the CLI's
``--profile DIR`` writes the trace and the counters of its load, set-up and
query. Tolerance: exact (integers)."""

import ast
import json
import pathlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from window_cases import lipschitz

from memo_tpu_torch import QueryEngine, cli
from memo_tpu_torch.index.builder import store_from_ms
from memo_tpu_torch.ops import fused_query
from memo_tpu_torch.parallel import ResidentShardedQuery, ShardedQuery
from memo_tpu_torch.query import engine as engine_mod
from memo_tpu_torch.utils import profiling

REC_LEN = 900
K = 51  # two live buckets of the stratified engine
WINDOWS = [(0, 300), (250, 900), (899, 900), (10, 11), (100, 650)]
PACKAGE = pathlib.Path(engine_mod.__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def mixed():
    """Half short and half long MS values (as tests/test_torch_query_sync.py
    builds them): stratified, bucket 0 holds most rows."""
    rng = np.random.default_rng(13)
    mix = np.where(rng.random((REC_LEN, 8)) < 0.5, rng.integers(0, 40, (REC_LEN, 8)),
                   rng.integers(100, 3000, (REC_LEN, 8))).astype(np.int32)
    return store_from_ms([lipschitz(mix)], ["chrA"], [REC_LEN], 9, "conservation")


@pytest.fixture(autouse=True)
def clean_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def traced(fn):
    """``fn()``'s result, the profiler's events of it and the counters."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.events(), profiling.counters()


def memo_spans(events) -> list:
    return [e for e in events if e.name.startswith("memo.")]


def parent_span(evt) -> str | None:
    """The name of the nearest enclosing ``memo.*`` span."""
    p = evt.cpu_parent
    while p is not None and not p.name.startswith("memo."):
        p = p.cpu_parent
    return None if p is None else p.name


def logged_steps(monkeypatch) -> list:
    """The window steps' WindowParams, as the engine finds them."""
    steps = []

    def logged(*args, _real=engine_mod.window_params, **kwargs):
        steps.append(_real(*args, **kwargs))
        return steps[-1]

    monkeypatch.setattr(engine_mod, "window_params", logged)
    return steps


def test_spans_of_a_stratified_query_nest_in_memo_query(mixed):
    eng = QueryEngine(mixed, device="cpu", stratify=True, chunk_positions=256)
    live = sum(lb < K - 1 for lb, _ in eng._children)
    assert live == 2
    _, events, _ = traced(lambda: eng.conservation("chrA", 0, REC_LEN, K))
    spans = memo_spans(events)
    names = [e.name for e in spans]
    assert names.count("memo.query") == 1
    assert names.count("memo.window_step") == live  # one step set a live bucket
    assert names.count("memo.launch") == live * 4  # a launch a chunk of 256, a bucket
    assert names.count("memo.join") == 1 and names.count("memo.copy_back") == 1
    for e in spans:
        assert not e.is_user_annotation, e.name
        assert parent_span(e) == (None if e.name == "memo.query" else "memo.query"), e.name


@pytest.mark.parametrize("max_windows", [None, 2])
def test_spans_of_a_batch_nest_in_memo_batch(mixed, monkeypatch, max_windows):
    """The batch's spans, also where its launches run as window groups:
    one ``memo.launch`` a live bucket, never one a window or group."""
    if max_windows:
        monkeypatch.setattr(fused_query, "MAX_WINDOWS", max_windows)
    eng = QueryEngine(mixed, device="cpu", stratify=True)
    _, events, _ = traced(lambda: eng.conservation_batch("chrA", WINDOWS, K))
    spans = memo_spans(events)
    names = [e.name for e in spans]
    assert names.count("memo.batch") == 1 and "memo.query" not in names
    for name, n in (("memo.window_step", 2), ("memo.launch", 2), ("memo.join", 1),
                    ("memo.copy_back", 1), ("memo.views", 1)):
        assert names.count(name) == n, (name, names)
    for e in spans:
        assert not e.is_user_annotation, e.name
        assert parent_span(e) == (None if e.name == "memo.batch" else "memo.batch"), e.name


def test_the_per_window_fallback_keeps_a_query_a_window(mixed):
    """Windows longer than a chunk run per window: a ``memo.query`` each,
    inside the batch."""
    eng = QueryEngine(mixed, device="cpu", stratify=False, chunk_positions=128)
    _, events, _ = traced(lambda: eng.conservation_batch("chrA", WINDOWS, K))
    queries = [e for e in events if e.name == "memo.query"]
    assert len(queries) == len(WINDOWS)
    assert all(parent_span(e) == "memo.batch" for e in queries)


@pytest.mark.parametrize("max_windows", [None, 2])
@pytest.mark.parametrize("stratify", [False, True])
def test_counters_equal_their_arithmetic(mixed, monkeypatch, max_windows, stratify):
    if max_windows:
        monkeypatch.setattr(fused_query, "MAX_WINDOWS", max_windows)
    eng = QueryEngine(mixed, device="cpu", stratify=stratify, chunk_positions=256)
    buckets = 2 if stratify else 1
    steps = logged_steps(monkeypatch)

    got, _, counts = traced(lambda: eng.conservation("chrA", 0, REC_LEN, K))
    # Chunks of 256, 256, 256 and 132 positions: Q x L of each launch.
    assert counts["memo.positions_launched"] == buckets * REC_LEN
    assert counts["memo.copy_back_bytes"] == got.nbytes
    assert counts["memo.candidate_rows"] == sum(int(wp.counts.sum()) for wp in steps)
    assert counts["memo.candidate_rows"] > 0

    profiling.reset_counters()
    steps.clear()
    eng = QueryEngine(mixed, device="cpu", stratify=stratify)  # the batch in one launch a bucket
    outs, _, counts = traced(lambda: eng.conservation_batch("chrA", WINDOWS, K))
    # Each window launched over its own length; the answers one packed array.
    positions = sum(qe - qs for qs, qe in WINDOWS)
    assert counts["memo.positions_launched"] == buckets * positions
    assert counts["memo.copy_back_bytes"] == outs[0].base.nbytes == positions * 4
    assert counts["memo.candidate_rows"] == sum(int(wp.counts.sum()) for wp in steps)


def test_membership_counts_its_bytes(mixed):
    store = store_from_ms([np.zeros((REC_LEN, 8), np.int32)], ["chrA"], [REC_LEN], 9,
                          "membership")
    eng = QueryEngine(store, device="cpu")
    got, _, counts = traced(lambda: eng.membership("chrA", 5, 205, K))
    assert got.shape == (200, 9) and counts["memo.copy_back_bytes"] == got.nbytes == 1800


def test_without_a_profiler_nothing_counts_and_the_bytes_are_the_same(mixed):
    eng = QueryEngine(mixed, device="cpu", stratify=True, chunk_positions=256)
    untraced = (eng.conservation("chrA", 0, REC_LEN, K), eng.conservation_batch("chrA", WINDOWS, K))
    assert profiling.counters() == {}
    traced_out, _, counts = traced(
        lambda: (eng.conservation("chrA", 0, REC_LEN, K), eng.conservation_batch("chrA", WINDOWS, K)))
    assert counts
    assert untraced[0].tobytes() == traced_out[0].tobytes()
    assert [a.tobytes() for a in untraced[1]] == [a.tobytes() for a in traced_out[1]]
    profiling.reset_counters()
    eng.conservation("chrA", 0, REC_LEN, K)  # after the profiler: nothing counts again
    assert profiling.counters() == {}


def test_spans_are_cpu_operations_and_off_costs_a_flag_check():
    """Off, ``span`` hands back one shared no-op context and ``count``
    returns at once; on, ``span`` is a CPU operation, never a user
    annotation, and ``count`` takes ints and tensors."""
    assert profiling.span("a") is profiling.span("b")
    profiling.count("memo.x", 5)
    assert profiling.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("memo.outer"):
            with profiling.span("memo.inner"):
                profiling.count("memo.x", 5)
                profiling.count("memo.x", torch.tensor([[1, 2], [3, 4]], dtype=torch.int32))
    events = {e.name: e for e in prof.events()}
    assert events["memo.inner"].cpu_parent.name == "memo.outer"
    assert not any(events[n].is_user_annotation for n in ("memo.outer", "memo.inner"))
    assert profiling.counters() == {"memo.x": 15}


def test_stage_timer_fills_global_times_and_opens_its_span():
    profiling.GLOBAL_TIMES.times.pop("place.test", None)
    with profiling.stage_timer("place.test", log_it=False):
        pass
    assert "place.test" in profiling.GLOBAL_TIMES.times
    mine = profiling.StageTimes()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.stage_timer("place.test", times=mine):
            torch.ones(4).sum()
    assert set(mine.times) == {"place.test"} and mine.times["place.test"] > 0
    stage = [e for e in prof.events() if e.name == "place.test"]
    assert len(stage) == 1 and not stage[0].is_user_annotation
    assert any(e.name == "aten::sum" and e.cpu_parent is stage[0] for e in prof.events())


def test_set_up_stages_are_spans(mixed):
    _, events, _ = traced(lambda: (
        QueryEngine(mixed, device="cpu", stratify=True),
        ResidentShardedQuery(mixed, "cpu", record="chrA", k_max=1024), ShardedQuery(mixed, "cpu")))
    names = {e.name for e in events}
    assert {"place.upload", "place.bounds", "place.sort_gather", "place.pad",
            "engine.bucket_split", "sharded.place"} <= names


@pytest.mark.parametrize("holder", ["resident", "sharded"])
def test_pinned_copy_backs_are_spans_with_their_bytes(mixed, holder):
    if holder == "resident":
        rq = ResidentShardedQuery(mixed, "cpu", record="chrA", k_max=1024)
        run = lambda: rq.conservation_windows(WINDOWS, K)  # noqa: E731
    else:
        sq = ShardedQuery(mixed, "cpu")
        run = lambda: sq.conservation([("chrA", qs, qe) for qs, qe in WINDOWS], K)  # noqa: E731
    got, events, counts = traced(run)
    copies = [e for e in events if e.name == "memo.copy_back"]
    assert len(copies) == 1
    rows = sum(qe - qs for qs, qe in WINDOWS) if holder == "resident" else (
        len(WINDOWS) * max(qe - qs for qs, qe in WINDOWS))
    assert counts["memo.copy_back_bytes"] == rows * 4
    assert sum(g.size for g in got) == sum(qe - qs for qs, qe in WINDOWS)


def test_cli_profile_writes_the_trace_and_the_counters(mixed, tmp_path):
    index = tmp_path / "idx.npz"
    mixed.save(str(index))
    trace = tmp_path / "trace"
    assert cli.main(["query", "-b", str(index), "-k", str(K), "-r", "chrA:0-900",
                     "-o", str(tmp_path / "c.txt"), "--device", "cpu", "--profile",
                     str(trace)]) == 0
    events = json.loads((trace / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"query.load_store", "query.engine_setup", "query.query", "memo.query",
            "memo.copy_back", "place.upload"} <= names
    counts = json.loads((trace / "counters.json").read_text())
    assert counts["memo.copy_back_bytes"] == REC_LEN * 4
    assert counts["memo.positions_launched"] >= REC_LEN and counts["memo.candidate_rows"] > 0


def test_only_the_profiling_module_records_spans():
    """No module of the package calls ``record_function`` (a user
    annotation, mirrored on the device); ``_RecordFunctionFast`` appears in
    ``utils/profiling.py`` alone."""
    users = set()
    for path in PACKAGE.rglob("*.py"):
        text = path.read_text()
        assert "record_function" not in text, path
        names = set()
        for n in ast.walk(ast.parse(text)):
            if isinstance(n, ast.Attribute):
                names.add(n.attr)
            elif isinstance(n, ast.Name):
                names.add(n.id)
            elif isinstance(n, ast.ImportFrom):
                names |= {a.name for a in n.names}
        if "_RecordFunctionFast" in names:
            users.add(path.relative_to(PACKAGE).as_posix())
    assert users == {"utils/profiling.py"}
