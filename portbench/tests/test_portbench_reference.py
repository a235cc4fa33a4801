"""The plain reference equals the program's numpy backend (memo_tpu's
host path, copied into the port) on windows of a generated index, and its
control does not."""

import numpy as np
import pytest

from memo_tpu_torch.index.store import IntervalStore
from memo_tpu_torch.query.engine import QueryEngine
from portbench.gen import synth_ms_overlaps as gen
from portbench.reference import conservation as ref


@pytest.fixture(scope="module")
def index():
    cfg = {"record": "chr1", "record_len": 60_000, "n_docs": 12, "gap": 25,
           "match_min": 8, "match_max": 120}
    inputs = gen.generate(cfg, 77, "cpu")
    store = IntervalStore(record_names=["chr1"], record_lens=[inputs.length], n_docs=inputs.n_docs,
                          kind="conservation", rec_id=np.zeros(inputs.start.size, np.int32),
                          start=inputs.start, end=inputs.end, order=inputs.order)
    return ref.Reference(inputs, "cpu"), QueryEngine(store, backend="numpy", device="cpu")


@pytest.mark.parametrize("k", [1, 3, 21, 31, 51, 101, 201])
@pytest.mark.parametrize("block", [ref.BLOCK, 1_000, 7])
def test_reference_equals_numpy_engine(index, k, block, monkeypatch):
    reference, engine = index
    monkeypatch.setattr(ref, "BLOCK", block)
    rng = np.random.default_rng(k)
    windows = [(0, 0), (0, 60_000), (59_990, 60_000), (123, 124)]
    windows += [(int(qs), int(qs) + int(n)) for qs, n in
                zip(rng.integers(0, 50_000, 6), rng.integers(1, 10_000, 6))]
    for qs, qe in windows:
        if block == 7 and qe - qs > 2_000:
            continue
        want = engine.conservation("chr1", qs, qe, k)
        got = reference.answer(qs, qe, k)
        assert got.dtype == np.int32 and np.array_equal(got, want), (qs, qe, k)


def test_control_breaks_exactness(index):
    reference, engine = index
    wrong = 0
    for qs in range(0, 50_000, 5_000):
        want = engine.conservation("chr1", qs, qs + 4_000, 31)
        wrong += int(np.count_nonzero(reference.control(qs, qs + 4_000, 31) != want))
    assert wrong > 0
