"""Every host answer of ``QueryEngine`` comes back in one copy and one wait.

On CUDA ``engine._to_host`` copies an answer into pinned memory
(``engine._copy_back``) and waits on the copy's event. Here that function
is stood in for by one that logs its call and returns a fresh copy with an
event that logs its wait, as the card's pinned copy is a fresh block an
answer. For the single whole-store, chunked whole-store (eight position
chunks, joined on the device), stratified (k = 31, 51 and 200: one, two and
three live buckets), batch and stratified batch paths, conservation and
membership, with ``device_output=False``, on the fused backend and (the
``torch-`` paths) on the ``torch`` backend, whose chunks, interval pieces
and per-window batch answers are joined on the device: a call makes
exactly one copy and one wait, its outputs equal memo_tpu's numpy engine,
the ``memo.copy_back_bytes`` counter equals the answer's bytes, and a
write into a returned answer reaches neither a repeat of the query nor a
later answer. Without the stand-in (the CPU's own path, where a CPU tensor
is its own host answer) a call opens one ``memo.copy_back`` span.
Tolerance: exact (integers)."""

import numpy as np
import pytest
from test_torch_query_sync import KS, REC_LEN, WINDOWS, _store, mixed  # noqa: F401 (fixture)
from torch.profiler import ProfilerActivity, profile

from memo_tpu.query.engine import QueryEngine as JaxEngine
from memo_tpu_torch import QueryEngine
from memo_tpu_torch.query import engine as engine_mod
from memo_tpu_torch.utils import profiling

PATHS = ("single", "chunked", "stratified", "batch", "batch-stratified")
TORCH_PATHS = tuple(f"torch-{path}" for path in PATHS)  # the same on the torch backend
MODES = ("conservation", "membership")


@pytest.fixture(autouse=True)
def clean_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def _engine(path: str, store) -> QueryEngine:
    backend = "torch" if path.startswith("torch-") else "fused"
    path = path.removeprefix("torch-")
    chunk = 128 if path in ("chunked", "stratified") else None
    eng = QueryEngine(store, backend=backend, chunk_positions=chunk,
                      stratify=path.endswith("stratified"), device="cpu")
    assert not eng.device_output
    return eng


def _query(path: str, eng, kind: str, k: int, record: str = "chrA") -> list:
    """The call's answers: one, or a batch's one a window."""
    if path.removeprefix("torch-").startswith("batch"):
        return getattr(eng, f"{kind}_batch")(record, WINDOWS, k)
    return [getattr(eng, kind)(record, 0, REC_LEN, k)]


def _want(path: str, oracle, kind: str, k: int, record: str = "chrA") -> list:
    windows = WINDOWS if path.removeprefix("torch-").startswith("batch") else ((0, REC_LEN),)
    return [getattr(oracle, kind)(record, qs, qe, k) for qs, qe in windows]


def _traced(fn):
    """``fn()``'s result, the profiler's events of it and the counters."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.events(), profiling.counters()


def _answer_bytes(path: str, got: list) -> int:
    """The bytes of the host array the call's answers live in: a batch's
    views share the packed [sum of lengths(, C)] array."""
    if path.removeprefix("torch-").startswith("batch"):
        assert all(g.base is got[0].base for g in got)
        return got[0].base.nbytes
    return got[0].nbytes


def _check_writes_stay_put(path, eng, oracle, kind, k, got) -> None:
    """A write into the first returned answer reaches neither another answer
    of the call, nor a repeat of the query, nor a later answer of another
    record."""
    got[0][...] = 7
    for g, w in zip(got[1:], _want(path, oracle, kind, k)[1:]):
        np.testing.assert_array_equal(g, w)
    for record in ("chrA", "chrB"):
        for g, w in zip(_query(path, eng, kind, k, record), _want(path, oracle, kind, k, record)):
            np.testing.assert_array_equal(g, w, err_msg=f"{path} {record} k={k}")


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("kind", MODES)
@pytest.mark.parametrize("path", PATHS + TORCH_PATHS)
def test_one_copy_and_one_wait_a_call(mixed, monkeypatch, path, kind, k):
    calls = []

    class Ready:
        def synchronize(self):
            calls.append("wait")

    def copy_back(t):
        calls.append(("copy", tuple(t.shape)))
        return t.clone(), Ready()

    monkeypatch.setattr(engine_mod, "_copy_back", copy_back)
    store = _store(mixed, kind)
    eng, oracle = _engine(path, store), JaxEngine(store, backend="numpy")
    got, _, counts = _traced(lambda: _query(path, eng, kind, k))
    assert [c if c == "wait" else c[0] for c in calls] == ["copy", "wait"], calls
    if path.removeprefix("torch-").startswith("batch"):
        assert calls[0][1][0] == sum(qe - qs for qs, qe in WINDOWS)  # packed: no padding
    else:
        assert calls[0][1][0] == REC_LEN
    for g, w in zip(got, _want(path, oracle, kind, k), strict=True):
        np.testing.assert_array_equal(g, w, err_msg=f"{path} k={k}")
    assert counts["memo.copy_back_bytes"] == _answer_bytes(path, got)
    _check_writes_stay_put(path, eng, oracle, kind, k, got)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("kind", MODES)
@pytest.mark.parametrize("path", PATHS)
def test_the_cpus_own_answer_is_one_span_and_no_pinned_bytes(mixed, path, kind, k):
    """No stand-in: ``_copy_back`` hands a CPU tensor back as itself, with
    no event, so the answer is the device step's own fresh output."""
    store = _store(mixed, kind)
    eng, oracle = _engine(path, store), JaxEngine(store, backend="numpy")
    got, events, counts = _traced(lambda: _query(path, eng, kind, k))
    assert [e.name for e in events].count("memo.copy_back") == 1
    for g, w in zip(got, _want(path, oracle, kind, k), strict=True):
        np.testing.assert_array_equal(g, w, err_msg=f"{path} k={k}")
    assert counts["memo.copy_back_bytes"] == _answer_bytes(path, got)
    _check_writes_stay_put(path, eng, oracle, kind, k, got)
