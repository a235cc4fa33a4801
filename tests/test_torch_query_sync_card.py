"""A fused query on the card queues all its work before the host waits.

Run under ``torch.cuda.set_sync_debug_mode("error")`` (any operation that
waits on the card raises), with ``torch.cuda.Event.synchronize`` and
``torch.cuda.synchronize`` recording their calls: under a provable cap (the
record's rows in every live bucket within ``max_intervals``) a query with
its output left on the card makes no wait, on one window, eight position
chunks, the stratified engine at k=51 (two live buckets) and a batch; each
output equals the same engine's on the CPU (the kernels' plain versions).
Under a cap below the record's rows, and under a cap of 16 that the
windows pass (each launched whole), a query waits on nothing too, and its
output and ``last_stats`` equal the CPU's at the same cap. The placed
tensors hold ``ROW_SLACK + 1`` sentinel rows. ``last_stats`` read on
another stream reads on the query's. The window step takes as many window
starts by value as its parameters hold and copies more up: both equal the
CPU's.
Imports no JAX, so it runs where the card is: ``MEMO_TPU_TEST_REAL_DEVICE=1
python -m pytest -m cuda tests/test_torch_query_sync_card.py``. Skips
without a CUDA device. Tolerance: exact (integers)."""

import numpy as np
import pytest
import torch

from memo_tpu_torch import QueryEngine
from memo_tpu_torch.index.builder import store_from_ms
from memo_tpu_torch.index.placement import place_store_and_layout
from memo_tpu_torch.ops.fused_query_v2 import ROW_SLACK
from memo_tpu_torch.query.window import inline_starts, window_params
from window_cases import lipschitz

REC_LEN = 900
WINDOWS = [(0, 300), (250, 900), (899, 900), (10, 11)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run there")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def store():
    """Half short and half long MS values over two records: bucket 0 holds
    most rows of the stratified engine."""
    rng = np.random.default_rng(13)
    mix = np.where(rng.random((REC_LEN, 8)) < 0.5, rng.integers(0, 40, (REC_LEN, 8)),
                   rng.integers(100, 3000, (REC_LEN, 8))).astype(np.int32)
    return store_from_ms([lipschitz(mix), lipschitz(mix[:400])], ["chrA", "chrB"],
                         [REC_LEN, 400], 9, "conservation")


@pytest.fixture
def waits(monkeypatch):
    """The calls of Event.synchronize and torch.cuda.synchronize."""
    calls = []
    real_event, real_sync = torch.cuda.Event.synchronize, torch.cuda.synchronize

    def event_sync(self):
        calls.append("event")
        return real_event(self)

    def sync(*args, **kwargs):
        calls.append("device")
        return real_sync(*args, **kwargs)

    monkeypatch.setattr(torch.cuda.Event, "synchronize", event_sync)
    monkeypatch.setattr(torch.cuda, "synchronize", sync)
    return calls


def _no_wait(fn):
    """``fn()`` with every operation that waits on the card raising."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


CASES = {  # (engine options, query)
    "one_window": ({}, lambda e: [e.conservation("chrA", 0, REC_LEN, 31)]),
    "eight_chunks": ({"chunk_positions": 128}, lambda e: [e.conservation("chrA", 0, REC_LEN, 31)]),
    "stratified_k51": ({"stratify": True}, lambda e: [e.conservation("chrA", 0, REC_LEN, 51)]),
    "batch": ({}, lambda e: e.conservation_batch("chrA", WINDOWS, 31)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_provable_cap_query_waits_on_nothing(cuda_device, store, waits, case):
    options, query = CASES[case]
    options = {"stratify": False} | options
    eng = QueryEngine(store, device=cuda_device, device_output=True, **options)
    plain = QueryEngine(store, device="cpu", device_output=True, **options)
    if case == "stratified_k51":
        assert sum(lb < 50 for lb, _ in eng._children) == 2
    query(eng)  # builds and loads the kernels
    torch.cuda.synchronize()
    waits.clear()
    got = _no_wait(lambda: query(eng))
    assert waits == [], waits
    stats = eng.last_stats.as_dict()  # read back now, after the query
    torch.cuda.synchronize()
    for g, w in zip(got, query(plain)):
        assert g.device.type == "cuda" and torch.equal(g.cpu(), w), case
    assert stats == plain.last_stats.as_dict()


def _capped(store, device, options: dict, cap) -> tuple:
    """The engine of ``options`` on ``device`` and its engines that hold
    rows, each capped at ``cap`` (a callable of the engines' rows of the
    record, or a number)."""
    eng = QueryEngine(store, device=device, device_output=True,
                      **({"stratify": False} | options))
    engines = [c for _, c in eng._children] if eng._children else [eng]
    cap = cap([int(np.diff(e._layout.rec_offsets)[0]) for e in engines]) if callable(cap) else cap
    for e in engines:
        e.max_intervals = cap
    return eng, engines


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_window", "stratified_k51", "batch"])
def test_unproven_cap_query_waits_once(cuda_device, store, waits, case):
    """A cap one below bucket 0's rows of the record, above every chunk's
    candidates: the query waits on nothing, and its output and
    ``last_stats`` equal the CPU's at the same cap."""
    options, query = CASES[case]
    eng, _ = _capped(store, cuda_device, options, lambda rows: max(rows) - 1)
    plain, _ = _capped(store, "cpu", options, lambda rows: max(rows) - 1)
    query(eng)
    torch.cuda.synchronize()
    waits.clear()
    got = _no_wait(lambda: query(eng))
    assert waits == [], waits
    for g, w in zip(got, query(plain)):
        assert torch.equal(g.cpu(), w), case
    assert eng.last_stats.as_dict() == plain.last_stats.as_dict()


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_window_over_a_small_cap_runs_whole(cuda_device, store, waits, case):
    """A cap of 16 candidates, which the windows pass: each chunk (or the
    batch) is launched once, whole, with no wait; the output equals the
    plain version's on the CPU, and ``last_stats`` (memo_tpu's halving,
    replayed when read) equals the CPU's."""
    options, query = CASES[case]
    eng, engines = _capped(store, cuda_device, options, 16)
    plain, _ = _capped(store, "cpu", options, 16)
    query(eng)
    torch.cuda.synchronize()
    waits.clear()
    got = _no_wait(lambda: query(eng))
    assert waits == [], waits
    for g, w in zip(got, query(plain)):
        assert torch.equal(g.cpu(), w), case
    assert eng.last_stats.as_dict() == plain.last_stats.as_dict()
    assert plain.last_stats.candidate_intervals > 0


@pytest.mark.cuda
@pytest.mark.parametrize("stratify", [False, True], ids=["whole", "stratified"])
def test_placed_rows_hold_row_slack_plus_one(cuda_device, store, stratify):
    """Each placed tensor on the card holds its rows and ``ROW_SLACK + 1``
    sentinel rows (start 0, end 0, order -1)."""
    eng = QueryEngine(store, device=cuda_device, stratify=stratify)
    for child in ([c for _, c in eng._children] if eng._children else [eng]):
        n = child._layout.num_rows
        for t, fill in zip(child._d, (0, 0, -1, 0, 0, -1)):
            assert t.is_cuda and t.shape == (n + ROW_SLACK + 1,) and bool((t[n:] == fill).all())


@pytest.mark.cuda
def test_stats_read_later_follow_the_querys_stream(cuda_device, store):
    """A query on a side stream held back by a sleep kernel, its
    ``last_stats`` then read on the default stream: the read is made on the
    query's stream, so it waits for the query (the side stream is idle
    after it) and the count equals the CPU's."""
    eng = QueryEngine(store, device=cuda_device, device_output=True, stratify=False)
    plain = QueryEngine(store, device="cpu", device_output=True, stratify=False)
    eng.conservation("chrA", 0, REC_LEN, 31)  # builds and loads the kernels
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(1 << 29)  # a quarter of a second at the H100's clock
        eng.conservation("chrA", 0, REC_LEN, 31)
    got = eng.last_stats.as_dict()
    assert side.query()
    plain.conservation("chrA", 0, REC_LEN, 31)
    assert got == plain.last_stats.as_dict()


@pytest.mark.cuda
@pytest.mark.parametrize("n_win", ["one", "all_by_value", "one_more", "twice"])
def test_starts_by_value_and_copied_equal_the_cpus(cuda_device, store, n_win):
    """Up to ``inline_starts()`` starts go in the kernel's parameters, more
    are copied up: params, prefix and counts equal the CPU's either way."""
    most = inline_starts()
    n_win = {"one": 1, "all_by_value": most, "one_more": most + 1, "twice": 2 * most}[n_win]
    on_cpu = place_store_and_layout(store, "cpu", 8)
    on_card = place_store_and_layout(store, cuda_device, 8)
    starts = [int(s) for s in np.linspace(0, REC_LEN + 50, n_win)]
    for L, k in ((1, 1), (37, 31), (REC_LEN, 200)):
        want = window_params(*on_cpu, 0, starts, L, k)
        got = window_params(*on_card, 0, starts, L, k)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), (n_win, L, k)
