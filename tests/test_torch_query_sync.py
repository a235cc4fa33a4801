"""A fused query reads nothing back, on the CPU with the card stood in for.

On CUDA the engine would bring tensors back through ``engine._copy_back``,
a pinned copy and an event to wait on. Here that function returns them with
a stand-in event that logs its wait, and every read of a tensor on the
host, every window step and every kernel launch is logged in order. For
the single-window, chunked, stratified (k = 31, 51 and 200: one, two and
three live buckets), batch and resident paths, conservation and
membership, at the default cap, at a cap below the record's rows in a
bucket and at a cap of 64 that most chunks pass: every window step comes
before the kernels, the query reads and waits on nothing, each chunk (or
batch) is launched once, whole, and the outputs equal memo_tpu's numpy
engine.

``last_stats`` read after a query equals memo_tpu's (``memo_stats.py``)
and its host-search count; the CLI's ``--stats`` line is that count.
Tolerance: exact (integers)."""

import dataclasses

import numpy as np
import pytest
import torch

from memo_tpu.index.builder import store_from_ms
from memo_tpu.query.engine import QueryEngine as JaxEngine
from memo_tpu.query.engine import QueryStats as JaxStats
from memo_tpu_torch import QueryEngine, cli
from memo_tpu_torch.query.engine import QueryStats
from memo_tpu_torch.index.store import IntervalStore
from memo_tpu_torch.parallel import ResidentShardedQuery
from memo_tpu_torch.query import engine as engine_mod
from memo_stats import memo_tpu_stats
from window_cases import lipschitz

REC_LEN = 900
WINDOWS = ((0, 300), (250, 900), (899, 900), (10, 11))
KS = (31, 51, 200)  # live buckets of the stratified engine: 1, 2 and 3
PATHS = ("single", "chunked", "stratified", "batch", "batch-stratified", "resident")


@pytest.fixture(scope="module")
def mixed():
    """memo_tpu's store of half short and half long MS values over two
    records (as tests/test_torch_window_params.py builds it): bucket 0
    holds most rows, buckets 32, 128 and 512 a few."""
    rng = np.random.default_rng(13)
    mix = np.where(rng.random((REC_LEN, 8)) < 0.5, rng.integers(0, 40, (REC_LEN, 8)),
                   rng.integers(100, 3000, (REC_LEN, 8))).astype(np.int32)
    return store_from_ms([lipschitz(mix), lipschitz(mix[:400])], ["chrA", "chrB"],
                         [REC_LEN, 400], 9, "conservation")


def _store(mixed, kind: str) -> IntervalStore:
    return IntervalStore(**{f.name: getattr(mixed, f.name) for f in dataclasses.fields(mixed)}
                         | {"kind": kind})


@pytest.fixture
def logged(monkeypatch):
    """``run(fn)``: ``fn()``'s result and the events it logged in order:
    "step" (a window step), "launch" (a kernel), "wait" (on the counts'
    copy) and "read" (a tensor read on the host, outside the steps' and
    kernels' plain versions)."""
    events, on = [], [False]

    class Copied:
        def synchronize(self):
            events.append("wait")

    monkeypatch.setattr(engine_mod, "_copy_back", lambda t: (t, Copied()))
    for method in ("tolist", "item", "numpy", "__int__", "__index__", "__bool__"):
        def read(self, *args, _real=getattr(torch.Tensor, method), **kwargs):
            if on[0]:
                events.append("read")
            return _real(self, *args, **kwargs)

        monkeypatch.setattr(torch.Tensor, method, read)
    for name, event in (("window_params", "step"), ("fused_query_rows", "launch"),
                        ("fused_query_v2_rows", "launch")):
        def quiet(*args, _real=getattr(engine_mod, name), _event=event, **kwargs):
            events.append(_event)
            was, on[0] = on[0], False
            try:
                return _real(*args, **kwargs)
            finally:
                on[0] = was

        monkeypatch.setattr(engine_mod, name, quiet)

    def run(fn):
        events.clear()
        on[0] = True
        try:
            out = fn()
        finally:
            on[0] = False
        return out, list(events)

    return run


def _engines(holder) -> list:
    """The engines that hold rows: the engine, or its buckets."""
    eng = holder.engine if isinstance(holder, ResidentShardedQuery) else holder
    return eng._engines()


def _rows(engine, record: str = "chrA") -> int:
    r = engine.store.record_index(record)
    return int(np.diff(engine._layout.rec_offsets)[r])


def _make(path: str, store, **options):
    if path == "resident":  # one record: a dispatch is one batch (one per record otherwise)
        return ResidentShardedQuery(store, "cpu", record="chrA", k_max=1024, device_output=True)
    chunk = 128 if path in ("chunked", "stratified") else None
    return QueryEngine(store, backend="fused", chunk_positions=chunk,
                       stratify=path.endswith("stratified"), device="cpu", device_output=True,
                       **options)


def _query(path: str, holder, kind: str, k: int) -> list:
    if path == "resident":  # a new dispatch each time
        holder._full_cache.clear()
        dispatches = holder.dispatch_count
        outs = getattr(holder, f"{kind}_windows")(WINDOWS, k, record="chrA")
        assert holder.dispatch_count == dispatches + 1
        return outs
    if path.startswith("batch"):
        return getattr(holder, f"{kind}_batch")("chrA", WINDOWS, k)
    return [getattr(holder, kind)("chrA", 0, REC_LEN, k)]


def _want(path: str, oracle, kind: str, k: int) -> list:
    windows = ((0, REC_LEN),) if path in ("single", "chunked", "stratified") else WINDOWS
    return [getattr(oracle, kind)("chrA", qs, qe, k) for qs, qe in windows]


def _set_cap(holder, cap: int) -> None:
    for engine in _engines(holder):
        engine.max_intervals = cap


def _unproven(holder) -> int:
    """A cap one below the largest bucket's rows of the record (bucket 0's):
    that bucket's cap cannot be proven; the others hold a few rows each."""
    return max(_rows(e) for e in _engines(holder)) - 1


@pytest.mark.parametrize("kind", ["conservation", "membership"])
@pytest.mark.parametrize("path", PATHS)
def test_provable_cap_reads_nothing(mixed, logged, path, kind):
    """Every queried record's rows in each live bucket are within the
    default cap: the query launches its kernels and makes no read and no
    wait; the outputs equal memo_tpu's numpy engine."""
    store = _store(mixed, kind)
    holder, oracle = _make(path, store), JaxEngine(store, backend="numpy")
    assert all(_rows(e) <= e.max_intervals for e in _engines(holder))
    for k in KS:
        got, events = logged(lambda: _query(path, holder, kind, k))
        assert "launch" in events and "read" not in events and "wait" not in events, events
        for g, w in zip(got, _want(path, oracle, kind, k)):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{path} k={k}")


@pytest.mark.parametrize("kind", ["conservation", "membership"])
@pytest.mark.parametrize("path", PATHS)
def test_unproven_cap_waits_once_after_every_launch(mixed, logged, path, kind):
    """A cap one below bucket 0's rows of the record, which no chunk's
    candidates pass: every window step comes before the kernels, and the
    query reads and waits on nothing; the outputs equal memo_tpu's numpy
    engine."""
    store = _store(mixed, kind)
    holder, oracle = _make(path, store), JaxEngine(store, backend="numpy")
    _set_cap(holder, _unproven(holder))
    for k in KS:
        got, events = logged(lambda: _query(path, holder, kind, k))
        assert "read" not in events and "wait" not in events, events
        last_step = max(i for i, e in enumerate(events) if e == "step")
        assert "launch" in events and last_step < events.index("launch"), events
        for g, w in zip(got, _want(path, oracle, kind, k)):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{path} k={k}")


@pytest.mark.parametrize("kind", ["conservation", "membership"])
@pytest.mark.parametrize("path", PATHS)
def test_over_cap_equals_numpy_engine(mixed, logged, path, kind):
    """A cap of 64 candidates, which most chunks pass: the query makes the
    same window steps and launches as under the default cap (each chunk,
    or the batch, launched once and whole), reads and waits on nothing,
    and the outputs still equal memo_tpu's numpy engine."""
    store = _store(mixed, kind)
    holder, oracle = _make(path, store), JaxEngine(store, backend="numpy")
    uncapped = _make(path, store)
    _set_cap(holder, 64)
    for k in KS:
        got, events = logged(lambda: _query(path, holder, kind, k))
        _, want_events = logged(lambda: _query(path, uncapped, kind, k))
        assert events == want_events and "launch" in events, (events, want_events)
        assert "read" not in events and "wait" not in events, events
        for g, w in zip(got, _want(path, oracle, kind, k)):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{path} k={k}")


def _host_candidates(mixed, chunks, k: int) -> int:
    """memo_tpu's count of a query's candidates over its position chunks:
    the larger of each chunk's two candidate ranges, from its host search
    (``_window_params``)."""
    jeng = JaxEngine(mixed, backend="pallas", stratify=False)
    return sum(max(p[1] - p[0], p[3] - p[2])
               for p in (jeng._window_params("chrA", qs, qe, k) for qs, qe in chunks))


def _memo_tpu_stats(path: str, store, k: int, cap: int | None) -> dict:
    """memo_tpu's stats of :func:`_query`'s query through ``path``."""
    window = {"windows": WINDOWS} if path.startswith("batch") else {"region": (0, REC_LEN)}
    chunk = 128 if path in ("chunked", "stratified") else None
    return memo_tpu_stats(store, "chrA", k, cap=cap, chunk_positions=chunk,
                          stratify=path.endswith("stratified"), **window)


@pytest.mark.parametrize("path", ["single", "chunked", "stratified", "batch", "batch-stratified"])
def test_last_stats_read_later_equal_the_eager_read(mixed, logged, path):
    """``last_stats`` of a query, read after it (the query reads nothing),
    equals memo_tpu's for the same cap, at the default cap and at a cap
    below bucket 0's rows of the record, and, unstratified, memo_tpu's
    host-search count; ``chunks`` and ``positions`` are the query's."""
    store = _store(mixed, "conservation")
    lazy, capped = _make(path, store), _make(path, store)
    _set_cap(capped, _unproven(capped))
    stratified = path.endswith("stratified")
    for k in KS:
        live = sum(lb < k - 1 for lb, _ in lazy._children) if stratified else 1
        for holder in (lazy, capped):
            _, events = logged(lambda: _query(path, holder, "conservation", k))
            assert "read" not in events
            cap = None if holder is lazy else _engines(holder)[0].max_intervals
            got = holder.last_stats.as_dict()
            assert got == _memo_tpu_stats(path, store, k, cap), (k, cap, got)
        assert got == lazy.last_stats.as_dict()
        if path.startswith("batch"):
            assert got["chunks"] == len(WINDOWS) * live
            assert got["positions"] == sum(qe - qs for qs, qe in WINDOWS)
            continue
        n_chunks = -(-REC_LEN // lazy.chunk_positions)
        assert got["chunks"] == n_chunks * live and got["positions"] == REC_LEN
        if not stratified:
            chunks = [(a, min(a + lazy.chunk_positions, REC_LEN))
                      for a in range(0, REC_LEN, lazy.chunk_positions)]
            assert got["candidate_intervals"] == _host_candidates(mixed, chunks, k)


def test_query_stats_is_memo_tpus_dataclass(mixed, logged):
    """``QueryStats`` is memo_tpu's dataclass: the same fields and defaults,
    equal by value whether its counts are read right after the query
    (under a cap below bucket 0's rows) or later, after the buckets' stats
    are added up, and ``dataclasses.asdict``, ``replace`` and ``repr`` give
    the counts read back. Adding stats up reads nothing."""
    assert ([(f.name, f.default) for f in dataclasses.fields(QueryStats)]
            == [(f.name, f.default) for f in dataclasses.fields(JaxStats)])
    assert QueryStats() == QueryStats(0, 0, 0) and QueryStats(1, 2, 3) != QueryStats(1, 2, 4)
    store = _store(mixed, "conservation")
    lazy, eager = _make("stratified", store), _make("stratified", store)
    _set_cap(eager, _unproven(eager))
    for k in KS:
        _query("stratified", eager, "conservation", k)
        eager.last_stats.as_dict()  # read at once
        _, events = logged(lambda: _query("stratified", lazy, "conservation", k))
        total, events = logged(lambda: _sum(lazy))
        assert events == [], events
        assert lazy.last_stats == eager.last_stats  # the first use reads the counts
        assert total == dataclasses.replace(eager.last_stats, positions=0)
        assert dataclasses.asdict(total) == dataclasses.asdict(eager.last_stats) | {"positions": 0}
        assert repr(total) == repr(dataclasses.replace(eager.last_stats, positions=0))
        assert dataclasses.replace(lazy.last_stats, chunks=7).as_dict() == (
            eager.last_stats.as_dict() | {"chunks": 7})


def _sum(holder) -> QueryStats:
    """The buckets' stats of the last query, added up."""
    total = QueryStats()
    for engine in _engines(holder):
        total.add(engine.last_stats)
    return total


def test_cli_stats_line_is_the_host_search_count(mixed, tmp_path, capsys):
    """``query --stats`` prints memo_tpu's line: the candidates its host
    search counts, one chunk, the window's positions."""
    npz = str(tmp_path / "mixed.npz")
    _store(mixed, "conservation").save(npz)
    for k, (qs, qe) in ((31, (0, REC_LEN)), (3, (100, 700))):
        assert cli.main(["query", "-b", npz, "-k", str(k), "-r", f"chrA:{qs}-{qe}", "-o",
                         str(tmp_path / "out.txt"), "--device", "cpu", "--stats"]) == 0
        line = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("stats: ")]
        want = {"candidate_intervals": _host_candidates(mixed, [(qs, qe)], k), "chunks": 1,
                "positions": qe - qs}
        assert line == [f"stats: {want}"]
