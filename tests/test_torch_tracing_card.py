"""The query path's spans and counters on the card.

Under ``torch.profiler`` with CUDA activity: the ``memo.*`` spans and the
stage spans are CPU operations only (no device event bears their names, so
the benchmark's device metrics read the kernels and copies alone), tracing
makes the query wait on nothing (``set_sync_debug_mode("error")`` with the
output left on the card), the counters equal the CPU engine's over the same
store (besides the v1 conservation launches' tile counters, which only the
kernels count: ``memo.apply_tiles`` and ``memo.event_tiles``, at most as
many), and the outputs equal the untraced ones. Imports no JAX, so it runs
where the card is: ``MEMO_TPU_TEST_REAL_DEVICE=1 python -m pytest -m cuda
tests/test_torch_tracing_card.py``. Skips without a CUDA device. Tolerance:
exact (integers)."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from window_cases import lipschitz

from memo_tpu_torch import QueryEngine
from memo_tpu_torch.index.builder import store_from_ms
from memo_tpu_torch.utils import profiling

REC_LEN = 900
K = 51  # two live buckets of the stratified engine
WINDOWS = [(0, 300), (250, 900), (899, 900), (10, 11), (100, 650)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run there")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def store():
    rng = np.random.default_rng(13)
    mix = np.where(rng.random((REC_LEN, 8)) < 0.5, rng.integers(0, 40, (REC_LEN, 8)),
                   rng.integers(100, 3000, (REC_LEN, 8))).astype(np.int32)
    return store_from_ms([lipschitz(mix)], ["chrA"], [REC_LEN], 9, "conservation")


def run(engine):
    return (engine.conservation("chrA", 0, REC_LEN, K), engine.conservation_batch("chrA", WINDOWS, K))


def traced(fn, activities):
    profiling.reset_counters()
    with profile(activities=activities) as prof:
        out = fn()
    return out, prof.events(), profiling.counters()


@pytest.mark.cuda
def test_spans_have_no_device_events_and_counts_equal_the_cpus(cuda_device, store):
    untraced = run(QueryEngine(store, device=cuda_device, stratify=True))
    cpu_out, _, cpu_counts = traced(
        lambda: run(QueryEngine(store, device="cpu", stratify=True)),
        [ProfilerActivity.CPU])
    out, events, counts = traced(
        lambda: run(QueryEngine(store, device=cuda_device, stratify=True)),
        [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    host = {e.name for e in events if not str(e.device_type).endswith("CUDA")}
    device = {e.name for e in events if str(e.device_type).endswith("CUDA")}
    ours = {"memo.query", "memo.batch", "memo.window_step", "memo.launch", "memo.join",
            "memo.copy_back", "memo.views", "place.upload", "place.sort_gather", "place.pad",
            "engine.bucket_split"}
    assert ours <= host
    assert any("window_params" in n for n in device)
    assert not device & ours and not any(n.startswith("memo.") for n in device)
    assert not any(e.is_user_annotation for e in events if e.name in ours)
    tiles = {"memo.apply_tiles", "memo.event_tiles"}
    assert {n: c for n, c in counts.items() if n not in tiles} == cpu_counts
    assert counts["memo.candidate_rows"] > 0 and tiles.isdisjoint(cpu_counts)
    assert 0 <= counts["memo.event_tiles"] <= counts["memo.apply_tiles"]
    for got, want, cpu in zip([out[0], *out[1]], [untraced[0], *untraced[1]],
                              [cpu_out[0], *cpu_out[1]]):
        assert got.tobytes() == want.tobytes() == cpu.tobytes()


@pytest.mark.cuda
def test_tracing_waits_on_nothing(cuda_device, store):
    engine = QueryEngine(store, device=cuda_device, stratify=True, device_output=True)
    want = run(engine)
    torch.cuda.synchronize()
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = run(engine)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(g, w) for g, w in zip(got[1], want[1]))
    counts = profiling.counters()
    # Two live buckets; the batch's windows each launched over its own length.
    assert counts["memo.positions_launched"] == 2 * (REC_LEN + sum(qe - qs for qs, qe in WINDOWS))
    assert "memo.copy_back_bytes" not in counts  # the outputs stayed on the card
