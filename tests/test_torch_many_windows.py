"""Batches of more windows than one kernel launch takes, on the CPU.

One launch takes at most ``fused_query.MAX_WINDOWS`` = 65,535 windows (v1
puts the window on grid axis y); memo_tpu runs any count. The engine
wrappers launch a larger batch as groups of consecutive windows
(``fused_query.launch_groups``), each group's parameters and prefix rows
of the bucket's one window step (no copy), each writing rows of the one
output. Here the limit is lowered to 3 and batches
of 10 windows run through the batch, stratified batch and resident paths
with both kernels (and with the column groups of a lowered width too):
every launch takes at most 3 windows and the groups cover the batch in
order, the outputs equal memo_tpu's numpy engine, ``last_stats`` equals
memo_tpu's (``memo_stats.py``: one replay of the bucket's whole window
step), and the window step stays one per bucket. A batch within the limit
makes exactly the launches it made before: one per live bucket, over the
whole window step and all columns.

Tolerance: exact (integers)."""

import numpy as np
import pytest
from memo_stats import memo_tpu_stats
from test_torch_query_sync import REC_LEN, _store, mixed  # noqa: F401 (fixture)
from test_torch_whole_windows import _resident_rows

from memo_tpu.query.engine import QueryEngine as JaxEngine
from memo_tpu_torch import QueryEngine
from memo_tpu_torch.ops import fused_query, fused_query_v2
from memo_tpu_torch.parallel import ResidentShardedQuery
from memo_tpu_torch.query import engine as engine_mod

WRAPPERS = {"fused_query_rows": fused_query, "fused_query_v2_rows": fused_query_v2}

# Ten windows of chrA: ragged, one position, empty, at and past the record's end.
WINDOWS = ((0, 300), (250, 900), (899, 900), (10, 11), (400, 400), (100, 650), (700, 900),
           (880, 960), (5, 105), (333, 777))
RESIDENT_CHUNK = 64  # resident answers chrA as ceil(900 / 64) = 15 windows
KS = (31, 51, 200)  # live buckets of the stratified store: 1, 2 and 3


@pytest.fixture
def logged(monkeypatch):
    """Each window step's window count, the parameter block of each, and
    each launch's (wrapper, Q, c0, G) and parameter rows."""
    log = {"steps": [], "step_params": [], "launches": [], "launch_params": []}

    def step(placed, layout, r, starts, L, k, _real=engine_mod.window_params):
        log["steps"].append(len(starts))
        wp = _real(placed, layout, r, starts, L, k)
        log["step_params"].append(wp.params)
        return wp

    monkeypatch.setattr(engine_mod, "window_params", step)
    for name, module in WRAPPERS.items():
        def launch(placed, params, prefix, out, n_rows, *, _real=module._launch_group, _name=name,
                   **kw):
            log["launches"].append((_name, params.shape[0], kw["c0"], kw["G"]))
            log["launch_params"].append(params)
            return _real(placed, params, prefix, out, n_rows, **kw)

        monkeypatch.setattr(module, "_launch_group", launch)
    return log


def _holder(path: str, store):
    if path == "resident":
        rq = ResidentShardedQuery(store, "cpu", record="chrA", k_max=1024, device_output=True)
        rq.engine.chunk_positions = RESIDENT_CHUNK
        for _, child in rq.engine._children or ():
            child.chunk_positions = RESIDENT_CHUNK
        return rq
    return QueryEngine(store, backend="fused", stratify=path == "batch-stratified",
                       device="cpu", device_output=True)


def _windows(path: str):
    if path == "resident":
        return [(qs, min(qs + RESIDENT_CHUNK, REC_LEN)) for qs in range(0, REC_LEN, RESIDENT_CHUNK)]
    return list(WINDOWS)


def _asked(path: str) -> list:
    """The windows a path is asked for: resident answers windows of the
    record, so there they end at its end."""
    return [(qs, min(qe, REC_LEN)) if path == "resident" else (qs, qe) for qs, qe in WINDOWS]


def _run(path: str, holder, kind: str, k: int) -> list:
    if path == "resident":
        holder._full_cache.clear()
        return getattr(holder, f"{kind}_windows")(_asked(path), k, record="chrA")
    return getattr(holder, f"{kind}_batch")("chrA", WINDOWS, k)


def _stats(path: str, store, k: int, membership: bool) -> dict:
    if path == "resident":
        return memo_tpu_stats(_resident_rows(store), "chrA", k, windows=_windows(path),
                              membership=membership)
    return memo_tpu_stats(store, "chrA", k, windows=WINDOWS, stratify=path != "batch",
                          membership=membership)


def _check_groups(launches: list, name: str, n_win: int, limit: int, C: int, width: int) -> int:
    """Each launch ran ``name`` over at most ``limit`` windows and ``width``
    columns; per bucket, the launches are window groups in order, each
    over its column groups in order. Returns the number of buckets."""
    assert launches and all(entry[0] == name for entry in launches), launches
    buckets, g0, c0 = 0, 0, 0
    for _, q, c, G in launches:
        assert 1 <= q <= limit and G <= width and c == c0, launches
        c0 = (c + G) % C
        if c0 == 0:
            g0 += q
            if g0 == n_win:
                buckets, g0 = buckets + 1, 0
    assert g0 == 0 and c0 == 0, launches
    return buckets


PATHS = ("batch", "batch-stratified", "resident")
CASES = [(v, p, w) for v in ("v1", "v2") for p in PATHS for w in (None, 4)]


@pytest.mark.parametrize("kind", ["conservation", "membership"])
@pytest.mark.parametrize("version,path,width", CASES,
                         ids=[f"{v}-{p}-{'width4' if w else 'whole'}" for v, p, w in CASES])
def test_window_groups_equal_memo_tpu(mixed, logged, monkeypatch, version, path, width,
                                      kind):  # noqa: F811
    """At most 3 windows a launch (and 4 columns, where ``width`` is set):
    the batch, in window groups, equals memo_tpu's numpy engine and its
    stats, with one window step per live bucket."""
    monkeypatch.setenv("MEMO_TPU_PALLAS_KERNEL", version)
    monkeypatch.setattr(fused_query, "MAX_WINDOWS", 3)
    C = mixed.n_docs
    if width:
        monkeypatch.setattr(fused_query, "MAX_COLUMNS", width)
        monkeypatch.setattr(fused_query_v2, "MAX_COLUMNS", width)
    store = _store(mixed, kind)
    holder, oracle = _holder(path, store), JaxEngine(store, backend="numpy")
    engine = holder.engine if path == "resident" else holder
    name = {"v1": "fused_query_rows", "v2": "fused_query_v2_rows"}[version]
    n_win = len(_windows(path))
    for k in KS:
        for entries in logged.values():
            entries.clear()
        got = _run(path, holder, kind, k)
        buckets = _check_groups(logged["launches"], name, n_win, 3, C, width or C)
        assert logged["steps"] == [n_win] * buckets, logged  # the window step stays whole
        for (qs, qe), g in zip(_asked(path), got):
            want = getattr(oracle, kind)("chrA", qs, qe, k)
            np.testing.assert_array_equal(g.numpy(), want, err_msg=f"{path} {qs}-{qe} k={k}")
        want = _stats(path, store, k, kind == "membership")
        assert engine.last_stats.as_dict() == want, (k, want)


@pytest.mark.parametrize("version", ["v1", "v2"])
@pytest.mark.parametrize("path", PATHS)
def test_batch_within_the_limit_launches_as_before(mixed, logged, monkeypatch, version,
                                                   path):  # noqa: F811
    """A batch of exactly the limit's windows: one launch per live bucket,
    over all of its windows and columns, its parameters the bucket's whole
    window step (the same tensor, no copy)."""
    monkeypatch.setenv("MEMO_TPU_PALLAS_KERNEL", version)
    n_win = len(_windows(path))
    monkeypatch.setattr(fused_query, "MAX_WINDOWS", n_win)
    holder = _holder(path, _store(mixed, "conservation"))
    name = {"v1": "fused_query_rows", "v2": "fused_query_v2_rows"}[version]
    for k in KS:
        for entries in logged.values():
            entries.clear()
        _run(path, holder, "conservation", k)
        assert logged["steps"] and set(logged["steps"]) == {n_win}
        assert logged["launches"] == [(name, n_win, 0, mixed.n_docs)] * len(logged["steps"])
        assert all(launch.data_ptr() == step.data_ptr() and launch.shape == step.shape
                   for launch, step in zip(logged["launch_params"], logged["step_params"]))
