"""Host answers on the card land in pinned memory.

On a stratified store: ``conservation``, ``membership`` and a batch's views
are numpy views of page-locked memory (``torch.from_numpy(a).is_pinned()``)
and equal the CPU engine's; an answer still held after 50 later queries
keeps its values; a query's device events are those of a pageable copy
(``engine._copy_back`` stood in for by ``.cpu()``) with ``Pageable``
replaced by ``Pinned``, and ``memo.copy_back_bytes`` the same. An engine
on a second card, with the first current and the second's stream held
back by a sleep kernel, hands
back answers equal to the CPU engine's as they are returned, though the
allocator's cached blocks hold -1s: the host
waits for the copy on the second card's stream, not on the current
device's (skips with fewer than two cards). Imports no JAX, so it runs
where the card is: ``MEMO_TPU_TEST_REAL_DEVICE=1 python -m pytest -m cuda
tests/test_torch_copy_back_card.py``. Skips without a CUDA device.
Tolerance: exact (integers)."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from window_cases import lipschitz

from memo_tpu_torch import QueryEngine
from memo_tpu_torch.index.builder import store_from_ms
from memo_tpu_torch.query import engine as engine_mod
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
def stores():
    """Half short and half long MS values, as a conservation and a
    membership store: bucket 0 holds most rows of the stratified engine."""
    rng = np.random.default_rng(13)
    mix = np.where(rng.random((REC_LEN, 8)) < 0.5, rng.integers(0, 40, (REC_LEN, 8)),
                   rng.integers(100, 3000, (REC_LEN, 8))).astype(np.int32)
    return {kind: store_from_ms([lipschitz(mix)], ["chrA"], [REC_LEN], 9, kind)
            for kind in ("conservation", "membership")}


def answers(engine, kind: str) -> list:
    """A whole-record answer and a batch's views."""
    return [getattr(engine, kind)("chrA", 0, REC_LEN, K),
            *getattr(engine, f"{kind}_batch")("chrA", WINDOWS, K)]


def device_names(events) -> list:
    return sorted(e.name for e in events if str(e.device_type).endswith("CUDA"))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["conservation", "membership"])
def test_answers_are_pinned_and_keep_their_values(cuda_device, stores, kind):
    engine = QueryEngine(stores[kind], device=cuda_device, stratify=True)
    cpu = answers(QueryEngine(stores[kind], device="cpu", stratify=True), kind)
    held = answers(engine, kind)
    assert all(torch.from_numpy(a).is_pinned() for a in held)
    kept = [a.copy() for a in held]
    for g, w in zip(held, cpu, strict=True):
        np.testing.assert_array_equal(g, w)
    for i in range(50):  # later answers take blocks of the host allocator's cache
        later = answers(engine, kind) if i % 2 else [getattr(engine, kind)("chrA", 0, 700, 31)]
        assert all(torch.from_numpy(a).is_pinned() for a in later)
    for g, w in zip(held, kept, strict=True):
        np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
def test_device_events_are_the_pageable_copys_with_pinned_memory(cuda_device, stores,
                                                                 monkeypatch):
    engine = QueryEngine(stores["conservation"], device=cuda_device, stratify=True)
    answers(engine, "conservation")
    torch.cuda.synchronize()

    def traced():
        profiling.reset_counters()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = answers(engine, "conservation")
        return out, prof.events(), profiling.counters()

    got, events, counts = traced()
    with monkeypatch.context() as m:
        m.setattr(engine_mod, "_copy_back", lambda t: (t.cpu(), None))
        want, pageable_events, pageable_counts = traced()
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
    pinned, pageable = device_names(events), device_names(pageable_events)
    # Two answers come back; the batch's ragged table went up (Pinned -> Device).
    assert sum("Device -> Pinned" in n for n in pinned) == 2
    assert not any("Pageable" in n for n in pinned)
    assert sum("Pageable" in n for n in pageable) == 2
    assert pinned == sorted(n.replace("Pageable", "Pinned") for n in pageable)
    assert pageable_counts["memo.copy_back_bytes"] == counts["memo.copy_back_bytes"] > 0


@pytest.mark.cuda
def test_an_engine_off_the_current_device_waits_for_its_own_copy(cuda_device, stores):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: the engine runs on the one not current")
    torch.cuda.set_device(0)
    for kind in ("conservation", "membership"):
        engine = QueryEngine(stores[kind], device="cuda:1", stratify=True)
        want = answers(QueryEngine(stores[kind], device="cpu", stratify=True), kind)
        held = answers(engine, kind)  # warm: the kernels' builds and the allocator's blocks
        for _ in range(3):
            for a in held:  # the blocks go back to the allocator's cache holding -1s
                a[...] = -1
            del a, held
            torch.cuda.synchronize(1)
            with torch.cuda.device(1):
                torch.cuda._sleep(1 << 29)  # a few hundred ms queued before the query
            assert torch.cuda.current_device() == 0
            held = answers(engine, kind)
            got = [a.copy() for a in held]  # read as soon as returned
            assert torch.cuda.current_device() == 0
            for g, w in zip(got, want, strict=True):
                np.testing.assert_array_equal(g, w, err_msg=kind)
