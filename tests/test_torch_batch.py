"""memo_tpu_torch QueryEngine.conservation_batch / membership_batch on the
CPU, for both kernel generations: every window equals the port's
single-window output and memo_tpu's numpy engine, the fused batch is one
kernel call (also over the candidate cap), and the fallbacks, the stratified engine, the empty batch and
the errors follow memo_tpu/query/engine.py:268-383. Also the kernel_version
selection. On the CPU both kernels run their plain version."""

import numpy as np
import pytest
import torch
from memo_stats import memo_tpu_stats
from test_pallas import _store
from test_torch_engine import mixed_store  # noqa: F401 (fixture)

from memo_tpu.index.builder import store_from_ms
from memo_tpu.query.engine import QueryEngine as JaxEngine
from memo_tpu_torch import QueryEngine
from memo_tpu_torch.query import engine as engine_mod

# test_pallas.py:181: ragged lengths, a window at the record tail, one position.
WINS = [(0, 200), (150, 420), (555, 800), (790, 800), (300, 301)]


@pytest.fixture(scope="module")
def cons_store():
    return _store(np.random.default_rng(21), True, n_records=1, n_docs=6, rec_len=800)


@pytest.fixture(scope="module")
def memb_store():
    return _store(np.random.default_rng(22), True, n_records=1, n_docs=6, rec_len=800,
                  kind="membership")


@pytest.fixture
def kernel_calls(monkeypatch):
    """Count calls of each kernel wrapper through the engine."""
    calls = {"v1": 0, "v2": 0}
    for version, name in (("v1", "fused_query_rows"), ("v2", "fused_query_v2_rows")):
        def counted(*args, _run=getattr(engine_mod, name), _v=version, **kwargs):
            calls[_v] += 1
            return _run(*args, **kwargs)

        monkeypatch.setattr(engine_mod, name, counted)
    return calls


@pytest.mark.parametrize("kernel_version", ["v1", "v2"])
@pytest.mark.parametrize("device_output", [False, True])
@pytest.mark.parametrize("k", [1, 3, 31])
def test_conservation_batch_matches_single_and_numpy(cons_store, kernel_calls, kernel_version,
                                                     device_output, k):
    eng = QueryEngine(cons_store, device="cpu", kernel_version=kernel_version,
                      device_output=device_output)
    oracle = JaxEngine(cons_store, backend="numpy")
    outs = eng.conservation_batch("chr0", WINS, k)
    assert kernel_calls[kernel_version] == 1  # one kernel call for the whole batch
    assert eng.last_stats.chunks == len(WINS)
    assert eng.last_stats.positions == sum(qe - qs for qs, qe in WINS)
    for (qs, qe), got in zip(WINS, outs):
        if device_output:
            assert isinstance(got, torch.Tensor)
            got = got.numpy()
        single = eng.conservation("chr0", qs, qe, k)
        single = single.numpy() if device_output else single
        np.testing.assert_array_equal(got, single, err_msg=f"{qs}-{qe}")
        np.testing.assert_array_equal(got, oracle.conservation("chr0", qs, qe, k))


@pytest.mark.parametrize("kernel_version", ["v1", "v2"])
@pytest.mark.parametrize("k", [3, 7])
def test_membership_batch_matches_single_and_numpy(memb_store, kernel_calls, kernel_version, k):
    eng = QueryEngine(memb_store, device="cpu", kernel_version=kernel_version)
    oracle = JaxEngine(memb_store, backend="numpy")
    outs = eng.membership_batch("chr0", WINS, k)
    assert kernel_calls[kernel_version] == 1
    for (qs, qe), got in zip(WINS, outs):
        assert got.dtype == np.int8 and got.shape == (qe - qs, memb_store.n_docs)
        np.testing.assert_array_equal(got, eng.membership("chr0", qs, qe, k))
        np.testing.assert_array_equal(got, oracle.membership("chr0", qs, qe, k))


@pytest.mark.parametrize("kernel_version", ["v1", "v2"])
def test_stratified_batch_matches_numpy(mixed_store, kernel_version):  # noqa: F811
    """Children min-combined; k so small that no bucket runs gives the
    all-pruned sentinel."""
    store = store_from_ms(mixed_store, ["c0"], [900], 9, "conservation")
    strat = QueryEngine(store, device="cpu", stratify=True, kernel_version=kernel_version)
    assert len(strat._children) >= 3
    oracle = JaxEngine(store, backend="numpy")
    wins = [(0, 900), (111, 700), (899, 900)]
    for k in (1, 2, 31, 130, 2100):
        for (qs, qe), got in zip(wins, strat.conservation_batch("c0", wins, k)):
            np.testing.assert_array_equal(got, oracle.conservation("c0", qs, qe, k),
                                          err_msg=f"{qs}-{qe} k={k}")
    memb = store_from_ms(mixed_store, ["c0"], [900], 9, "membership")
    sm = QueryEngine(memb, device="cpu", stratify=True, kernel_version=kernel_version)
    om = JaxEngine(memb, backend="numpy")
    for k in (2, 31):
        for (qs, qe), got in zip(wins, sm.membership_batch("c0", wins, k)):
            np.testing.assert_array_equal(got, om.membership("c0", qs, qe, k))


@pytest.mark.parametrize(
    "options", [{"max_intervals_per_chunk": 4}, {"chunk_positions": 100},
                {"backend": "torch"}, {"backend": "numpy"}],
    ids=["over-cap", "longer-than-chunk", "torch", "numpy"],
)
def test_batch_falls_back_per_window(cons_store, kernel_calls, options):
    eng = QueryEngine(cons_store, device="cpu", **options)
    oracle = JaxEngine(cons_store, backend="numpy")
    single = [eng.conservation("chr0", qs, qe, 31) for qs, qe in WINS]
    calls_single = dict(kernel_calls)
    outs = eng.conservation_batch("chr0", WINS, 31)
    if "max_intervals_per_chunk" in options:  # over the cap: still one launch, no fallback
        assert kernel_calls["v1"] == calls_single["v1"] + 1 == len(WINS) + 1
        assert eng.last_stats.as_dict() == memo_tpu_stats(cons_store, "chr0", 31, cap=4,
                                                          windows=WINS)
    elif eng.backend == "fused":  # as many kernel calls as the per-window queries made
        assert kernel_calls["v1"] == 2 * calls_single["v1"] > len(WINS)
    for (qs, qe), got, one in zip(WINS, outs, single):
        np.testing.assert_array_equal(got, one)
        np.testing.assert_array_equal(got, oracle.conservation("chr0", qs, qe, 31))
    assert eng.last_stats.positions == sum(qe - qs for qs, qe in WINS)


def test_empty_batch_and_empty_windows(cons_store):
    eng = QueryEngine(cons_store, device="cpu")
    assert eng.conservation_batch("chr0", [], 31) == []
    assert eng.membership_batch("chr0", [], 31) == []
    cons = eng.conservation_batch("chr0", [(5, 5), (9, 9)], 31)
    memb = eng.membership_batch("chr0", [(5, 5)], 31)
    assert [c.shape for c in cons] == [(0,), (0,)]
    assert memb[0].shape == (0, cons_store.n_docs)


@pytest.mark.parametrize("backend", ["fused", "torch", "numpy"])
def test_batch_errors(cons_store, backend):
    eng = QueryEngine(cons_store, backend=backend, device="cpu")
    with pytest.raises(ValueError, match="empty/negative window"):
        eng.conservation_batch("chr0", [(0, 10), (10, 9)], 31)
    with pytest.raises(ValueError, match="k must be"):
        eng.membership_batch("chr0", [(0, 10)], 0)


def test_kernel_version_default_env_and_errors(cons_store, monkeypatch):
    monkeypatch.delenv("MEMO_TPU_PALLAS_KERNEL", raising=False)
    assert QueryEngine(cons_store, device="cpu").kernel_version == "v1"
    monkeypatch.setenv("MEMO_TPU_PALLAS_KERNEL", "v2")
    assert QueryEngine(cons_store, device="cpu").kernel_version == "v2"
    assert QueryEngine(cons_store, device="cpu", kernel_version="v1").kernel_version == "v1"
    with pytest.raises(ValueError, match="unknown kernel_version"):
        QueryEngine(cons_store, device="cpu", kernel_version="v3")
    monkeypatch.setenv("MEMO_TPU_PALLAS_KERNEL", "v0")
    with pytest.raises(ValueError, match="unknown kernel_version"):
        QueryEngine(cons_store, device="cpu")


def test_kernel_version_matches_jax_engine_resolution(cons_store, monkeypatch):
    for env in (None, "v1", "v2"):
        if env is None:
            monkeypatch.delenv("MEMO_TPU_PALLAS_KERNEL", raising=False)
        else:
            monkeypatch.setenv("MEMO_TPU_PALLAS_KERNEL", env)
        for arg in (None, "v1", "v2"):
            assert (QueryEngine(cons_store, device="cpu", kernel_version=arg).kernel_version
                    == JaxEngine(cons_store, backend="numpy", kernel_version=arg).kernel_version)


def test_stratified_children_inherit_kernel_version(mixed_store, kernel_calls,  # noqa: F811
                                                    monkeypatch):
    monkeypatch.setenv("MEMO_TPU_PALLAS_KERNEL", "v2")
    store = store_from_ms(mixed_store, ["c0"], [900], 9, "conservation")
    strat = QueryEngine(store, device="cpu", stratify=True)
    assert {child.kernel_version for _, child in strat._children} == {"v2"}
    strat.conservation("c0", 0, 900, 600)
    assert kernel_calls["v2"] >= 2 and kernel_calls["v1"] == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused backend launches its kernels there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel_version", ["v1", "v2"])
@pytest.mark.parametrize("kind", ["conservation", "membership"])
def test_cuda_batch_matches_numpy_oracle(cuda_device, kernel_version, kind):
    from memo_tpu_torch.ops.fused_query import fused_query_rows
    from memo_tpu_torch.ops.fused_query_v2 import fused_query_v2_rows

    store = _store(np.random.default_rng(29), True, kind=kind, n_records=2, n_docs=16,
                   rec_len=3000)
    oracle = JaxEngine(store, backend="numpy")
    eng = QueryEngine(store, device=cuda_device, kernel_version=kernel_version)
    run = fused_query_rows if kernel_version == "v1" else fused_query_v2_rows
    wins = [(0, 3000), (123, 2456), (2990, 3000), (1500, 1501)]
    fn = getattr(eng, f"{kind}_batch")
    for k in (1, 3, 31, 101):
        before = run.launches
        outs = fn("chr1", wins, k)
        assert run.launches == before + 1
        for (qs, qe), got in zip(wins, outs):
            np.testing.assert_array_equal(got, getattr(oracle, kind)("chr1", qs, qe, k))
