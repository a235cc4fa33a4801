"""The v1 wrapper's tile counters, on the CPU.

``fused_query_rows`` hands the kernels an int32 for the count of the tiles
that took the event path only while a profiler records and only for
conservation; it then counts the launch's tiles in ``memo.apply_tiles`` (a
ragged launch: its windows' own tiles, not the spare units) and that count
in ``memo.event_tiles``, read with the counters. The kernels are stood in
for by a stub that records the count's tensor and sets it to half the
launch's tiles. On the CPU path (the plain version) nothing is counted, traced or
not, and the answers are the same bytes. Tolerance: exact (integers)."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from window_cases import lipschitz

from memo_tpu_torch import QueryEngine
from memo_tpu_torch.index.builder import store_from_ms
from memo_tpu_torch.ops import fused_query
from memo_tpu_torch.ops.fused_query import Offsets, fused_query_rows
from memo_tpu_torch.utils import profiling

REC_LEN = 900
K = 31
WINDOWS = [(0, 300), (250, 900), (899, 900), (10, 11), (100, 650), (40, 40)]


@pytest.fixture(scope="module")
def store():
    rng = np.random.default_rng(24)
    mix = np.where(rng.random((REC_LEN, 8)) < 0.5, rng.integers(0, 40, (REC_LEN, 8)),
                   rng.integers(100, 3000, (REC_LEN, 8))).astype(np.int32)
    return store_from_ms([lipschitz(mix)], ["chrA"], [REC_LEN], 9, "conservation")


@pytest.fixture(autouse=True)
def clean_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


class StubKernels:
    """The kernel library's entry point: each launch's event count recorded
    (the int32 tensor the wrapper made for it, or None) and set to half the
    launch's tiles (Q x ceil(L / tile), or a ragged launch's units)."""

    def __init__(self):
        self.made = []  # the int32 tensors the wrapper made
        self.counts = []
        self.tiles = []

    def memo_fused_query_rows(self, *args):
        ptr, total, n_win, L, tile = args[11], args[12], args[14], args[15], args[20]
        tiles = total // tile + n_win if args[10] is not None else n_win * -(-L // tile)
        events = None
        if ptr is not None:
            events = next(t for t in self.made if t.data_ptr() == ptr)
            assert events.shape == (1,)
            events.fill_(tiles // 2)
        self.counts.append(events)
        self.tiles.append(tiles)
        return 0


@pytest.fixture
def stub(monkeypatch):
    """fused_query_rows on CPU tensors taking its kernel branch, with the
    kernels stood in for."""
    kernels = StubKernels()
    real_empty = torch.empty

    def empty(*shape, dtype=None, **kw):
        t = real_empty(*shape, dtype=dtype, **kw)
        if dtype == torch.int32:
            kernels.made.append(t)
        return t

    monkeypatch.setattr(fused_query, "check_rows_launch", lambda *a, **kw: 1_000)
    monkeypatch.setattr(fused_query, "load_library", lambda: kernels)
    monkeypatch.setattr(fused_query, "launch", lambda entry, device, *args: entry(*args, None))
    monkeypatch.setattr(fused_query.torch, "empty", empty)
    return kernels


def params(n_win):
    return torch.zeros((n_win, 5), dtype=torch.int32), torch.zeros((n_win, 9), dtype=torch.int32)


def placed():
    return tuple(torch.zeros(4, dtype=torch.int32) for _ in range(6))


def run(n_win, L, membership=False, offsets=None):
    p, prefix = params(n_win)
    return fused_query_rows(placed(), p, prefix, k=K, L=L, C=9, n_docs=9, membership=membership,
                            offsets=offsets)


def traced(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    return profiling.counters()


@pytest.mark.parametrize("L", [1, 256, 257, 1000])
def test_a_traced_uniform_launch_counts_its_tiles(stub, L):
    counts = traced(lambda: run(3, L))
    tiles = 3 * -(-L // fused_query.rows_tile(9))
    assert stub.counts[-1] is not None and stub.tiles[-1] == tiles
    assert counts["memo.apply_tiles"] == tiles
    assert counts["memo.event_tiles"] == tiles // 2


def test_a_traced_ragged_launch_counts_its_windows_tiles(stub):
    lengths = np.array([qe - qs for qs, qe in WINDOWS])
    host = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    offsets = Offsets(host, torch.from_numpy(host))
    counts = traced(lambda: run(len(WINDOWS), int(lengths.max()), offsets=offsets))
    T = fused_query.rows_tile(9)
    units = fused_query.ragged_units(int(host[-1]), len(WINDOWS), T)
    assert stub.tiles[-1] == units  # the launch's units, spare ones too
    assert counts["memo.apply_tiles"] == sum(-(-m // T) for m in lengths) < units
    assert counts["memo.event_tiles"] == units // 2


def test_untraced_or_membership_launches_take_no_count(stub):
    run(2, 300)
    run(2, 300, membership=True)
    assert stub.counts == [None, None] and profiling.counters() == {}
    counts = traced(lambda: run(2, 300, membership=True))
    assert stub.counts[-1] is None
    assert "memo.apply_tiles" not in counts and "memo.event_tiles" not in counts


@pytest.mark.parametrize("stratify", [False, True])
def test_the_cpu_path_counts_no_tile(store, stratify):
    eng = QueryEngine(store, device="cpu", stratify=stratify, chunk_positions=256)
    untraced = (eng.conservation("chrA", 0, REC_LEN, K), eng.conservation_batch("chrA", WINDOWS, K))
    counts = traced(lambda: (eng.conservation("chrA", 0, REC_LEN, K),
                             eng.conservation_batch("chrA", WINDOWS, K)))
    assert counts["memo.positions_launched"] > 0
    assert "memo.apply_tiles" not in counts and "memo.event_tiles" not in counts
    again = (eng.conservation("chrA", 0, REC_LEN, K), eng.conservation_batch("chrA", WINDOWS, K))
    assert untraced[0].tobytes() == again[0].tobytes()
    assert [a.tobytes() for a in untraced[1]] == [a.tobytes() for a in again[1]]
