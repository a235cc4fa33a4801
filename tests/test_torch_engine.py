"""memo_tpu_torch QueryEngine on the CPU, every backend, held exactly against
memo_tpu's QueryEngine: its numpy oracle everywhere, and its fused Pallas
path (interpret mode) for the slice as a whole."""

import numpy as np
import pytest
import torch
from memo_stats import memo_tpu_stats
from test_pallas import WINDOWS, _lipschitz, _store

from memo_tpu.index.builder import store_from_ms
from memo_tpu.query.engine import QueryEngine as JaxEngine
from memo_tpu_torch import QueryEngine
from memo_tpu_torch.query import engine as engine_mod
from memo_tpu_torch.query.engine import place_store

BACKENDS = ["fused", "torch", "numpy"]
GOLDEN_DAP = np.array([[3, 2, 1], [2, 1, 5], [1, 4, 4], [5, 3, 3], [4, 2, 2]], np.int32)


def _golden(kind):
    return store_from_ms([GOLDEN_DAP], ["chrA"], [5], n_docs=4, kind=kind)


@pytest.fixture(scope="module", params=[True, False], ids=["monotone", "random"])
def stores(request):
    return _store(np.random.default_rng(3), request.param)


@pytest.fixture(scope="module")
def membership_store():
    return _store(np.random.default_rng(11), True, kind="membership")


@pytest.fixture(scope="module")
def mixed_store():
    """Half short and half long intervals: splits into at least 3 buckets."""
    rng = np.random.default_rng(13)
    mix = np.where(
        rng.random((900, 8)) < 0.5, rng.integers(0, 40, (900, 8)), rng.integers(100, 3000, (900, 8))
    ).astype(np.int32)
    return [_lipschitz(mix)]


@pytest.mark.parametrize("backend", BACKENDS)
def test_golden_vectors(backend):
    cons = QueryEngine(_golden("conservation"), backend=backend, device="cpu")
    assert cons.conservation("chrA", 0, 5, 3).tolist() == [2, 2, 3, 4, 2]
    assert cons.conservation("chrA", 0, 5, 2).tolist() == [3, 3, 3, 4, 4]
    memb = QueryEngine(_golden("membership"), backend=backend, device="cpu")
    assert memb.membership("chrA", 0, 5, 3).tolist() == [
        [1, 1, 0, 0], [1, 0, 0, 1], [1, 0, 1, 1], [1, 1, 1, 1], [1, 1, 0, 0]
    ]


@pytest.mark.parametrize("k", [1, 2, 3, 31, 101])
@pytest.mark.parametrize("backend", BACKENDS)
def test_conservation_matches_numpy_oracle(stores, backend, k):
    eng = QueryEngine(stores, backend=backend, device="cpu")
    oracle = JaxEngine(stores, backend="numpy")
    for rec, qs, qe in WINDOWS:
        got = eng.conservation(rec, qs, qe, k)
        want = oracle.conservation(rec, qs, qe, k)
        np.testing.assert_array_equal(got, want, err_msg=f"{backend} {rec}:{qs}-{qe} k={k}")


@pytest.mark.parametrize("k", [1, 3, 31])
@pytest.mark.parametrize("backend", BACKENDS)
def test_membership_matches_numpy_oracle(membership_store, backend, k):
    eng = QueryEngine(membership_store, backend=backend, device="cpu")
    oracle = JaxEngine(membership_store, backend="numpy")
    for rec, qs, qe in WINDOWS:
        got = eng.membership(rec, qs, qe, k)
        assert got.dtype == np.int8
        np.testing.assert_array_equal(got, oracle.membership(rec, qs, qe, k))


@pytest.mark.parametrize("n_docs", [129, 257])
def test_wide_stores_match_numpy_oracle(n_docs):
    """Widths past one 128-column block, and past the widest 256-position tile."""
    store = _store(np.random.default_rng(n_docs), True, n_records=1, n_docs=n_docs, rec_len=300)
    oracle = JaxEngine(store, backend="numpy")
    for backend in ("fused", "torch"):
        eng = QueryEngine(store, backend=backend, device="cpu")
        for qs, qe, k in [(0, 300, 31), (77, 204, 3)]:
            np.testing.assert_array_equal(
                eng.conservation("chr0", qs, qe, k), oracle.conservation("chr0", qs, qe, k)
            )


@pytest.mark.parametrize("backend", ["fused", "torch"])
def test_chunked_equals_unchunked(stores, backend):
    whole = QueryEngine(stores, backend=backend, device="cpu")
    small = QueryEngine(stores, backend=backend, device="cpu", chunk_positions=17)
    for k in (1, 31):
        np.testing.assert_array_equal(
            small.conservation("chr0", 0, 700, k), whole.conservation("chr0", 0, 700, k)
        )
    assert small.last_stats.chunks == -(-700 // 17)
    assert small.last_stats.positions == 700


@pytest.mark.parametrize("backend", ["fused", "torch"])
@pytest.mark.parametrize("device_output", [False, True])
def test_over_cap_halves_then_splits_interval_pieces(monkeypatch, stores, backend, device_output):
    """A cap of 4 candidates. The torch backend halves the position chunk,
    and its candidates at one position (every row that may reach it) still
    exceed the cap, so it also runs min-combined interval pieces. The fused
    backend launches each window whole (its kernels read only the candidate
    ranges), once a query, and its ``last_stats`` replays memo_tpu's
    halving: equal to memo_tpu's fused engine's at the same cap."""
    calls = {"_launch_chunks": 0, "_query_interval_pieces": 0}
    for name in calls:
        orig = getattr(engine_mod.QueryEngine, name)

        def spy(self, *args, _name=name, _orig=orig):
            calls[_name] += 1
            return _orig(self, *args)

        monkeypatch.setattr(engine_mod.QueryEngine, name, spy)
    eng = QueryEngine(stores, backend=backend, device="cpu", max_intervals_per_chunk=4,
                      device_output=device_output)
    oracle = JaxEngine(stores, backend="numpy")
    for qs, qe, k in [(100, 228, 31), (0, 64, 3)]:
        got = eng.conservation("chr0", qs, qe, k)
        if device_output:
            assert isinstance(got, torch.Tensor)
            got = got.numpy()
        np.testing.assert_array_equal(got, oracle.conservation("chr0", qs, qe, k))
        if backend == "fused":
            assert eng.last_stats.as_dict() == memo_tpu_stats(stores, "chr0", k, cap=4,
                                                              region=(qs, qe))
    if backend == "torch":
        assert calls["_query_interval_pieces"] > 0
        assert eng.last_stats.chunks > 1  # each piece is a dispatch
    else:
        assert calls == {"_launch_chunks": 2, "_query_interval_pieces": 0}


@pytest.mark.parametrize("backend", ["fused", "torch"])
def test_stratified_engine_matches_numpy_oracle(mixed_store, backend):
    store = store_from_ms(mixed_store, ["c0"], [900], 9, "conservation")
    strat = QueryEngine(store, backend=backend, device="cpu", stratify=True)
    assert strat._children is not None and len(strat._children) >= 3
    oracle = JaxEngine(store, backend="numpy")
    for qs, qe in [(0, 900), (111, 700), (899, 900)]:
        for k in (1, 2, 31, 33, 101, 130, 600, 2100, 5000):
            np.testing.assert_array_equal(
                strat.conservation("c0", qs, qe, k),
                oracle.conservation("c0", qs, qe, k),
                err_msg=f"{qs}-{qe} k={k}",
            )
    strat.conservation("c0", 0, 900, 31)  # k=31 dispatches bucket 0 only
    assert strat.last_stats.candidate_intervals <= strat._children[0][1]._layout.num_rows

    memb = store_from_ms(mixed_store, ["c0"], [900], 9, "membership")
    sm = QueryEngine(memb, backend=backend, device="cpu", stratify=True)
    om = JaxEngine(memb, backend="numpy")
    for k in (2, 31, 600):
        np.testing.assert_array_equal(sm.membership("c0", 0, 900, k), om.membership("c0", 0, 900, k))


def test_auto_stratify_gate_matches_jax_engine(stores):
    """Small stores stay unstratified under "auto" in both packages."""
    for backend in ("fused", "torch"):
        assert QueryEngine(stores, backend=backend, device="cpu")._children is None
    assert JaxEngine(stores, backend="jax")._children is None


@pytest.mark.parametrize("backend", [*BACKENDS, "fused-stratified", "torch-stratified"])
@pytest.mark.parametrize("device_output", [False, True])
def test_empty_window_shapes(stores, backend, device_output):
    """An empty window's shapes, and its dtypes as memo_tpu's engine of the
    same backend kind and stratification gives them: on the host a plain
    engine's conservation is int64[0] (numpy's join of no chunks) and a
    stratified one's int32[0]."""
    backend, _, stratify = backend.partition("-")
    eng = QueryEngine(stores, backend=backend, device="cpu", device_output=device_output,
                      stratify=bool(stratify))
    assert (eng._children is not None) == bool(stratify)
    oracle = JaxEngine(stores, backend="numpy")
    memo = JaxEngine(stores, backend="numpy" if backend == "numpy" else "jax",
                     device_output=device_output, stratify=bool(stratify))
    cons = eng.conservation("chr0", 5, 5, 31)
    memb = eng.membership("chr0", 5, 5, 31)
    want_c, want_m = oracle.conservation("chr0", 5, 5, 31), oracle.membership("chr0", 5, 5, 31)
    assert tuple(cons.shape) == want_c.shape == (0,)
    assert tuple(memb.shape) == want_m.shape == (0, stores.n_docs)
    assert memb.dtype in (np.int8, torch.int8)
    for got, want in ((cons, memo.conservation("chr0", 5, 5, 31)),
                      (memb, memo.membership("chr0", 5, 5, 31))):
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype), (got.dtype, want.dtype)


@pytest.mark.parametrize("backend", BACKENDS)
def test_bad_queries_raise(stores, backend):
    eng = QueryEngine(stores, backend=backend, device="cpu")
    with pytest.raises(ValueError, match="k must be"):
        eng.conservation("chr0", 0, 10, 0)
    with pytest.raises(ValueError, match="empty/negative"):
        eng.membership("chr0", 10, 9, 31)


def test_bad_backend_and_auto():
    with pytest.raises(ValueError, match="unknown backend"):
        QueryEngine(_golden("conservation"), backend="pallas", device="cpu")
    assert QueryEngine(_golden("conservation"), device="cpu").backend == "fused"


def test_place_store(stores):
    pad = 64
    placed = place_store(stores, "cpu", pad)
    lay = stores.query_layout()
    n = stores.num_intervals
    for got, src, fill in zip(
        placed,
        (stores.start, stores.end, stores.order, lay.end_sorted, lay.start_by_end, lay.order_by_end),
        (0, 0, -1, 0, 0, -1),
    ):
        assert got.dtype == torch.int32 and got.shape == (n + pad,) and got.device.type == "cpu"
        np.testing.assert_array_equal(got[:n].numpy(), src)
        assert (got[n:] == fill).all()


def test_device_defaults():
    eng = QueryEngine(_golden("conservation"), backend="fused", device="cpu")
    assert (eng.chunk_positions, eng.max_intervals) == (1 << 17, 1 << 22)


def test_cuda_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        QueryEngine(_golden("conservation"), backend="fused", device="cuda")


@pytest.mark.parametrize("kind", ["conservation", "membership"])
def test_slice_matches_jax_pallas_engine(kind):
    """The whole slice (host ranges, stream set-up, fused reduction) against
    memo_tpu's fused Pallas engine in interpret mode, one window each."""
    store = _store(np.random.default_rng(17), True, kind=kind, n_records=1, rec_len=500)
    jax_eng = JaxEngine(store, backend="pallas", stratify=False)
    eng = QueryEngine(store, backend="fused", device="cpu")
    fn = "membership" if kind == "membership" else "conservation"
    np.testing.assert_array_equal(
        getattr(eng, fn)("chr0", 31, 480, 31), getattr(jax_eng, fn)("chr0", 31, 480, 31)
    )


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused backend launches its kernel there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["conservation", "membership"])
def test_cuda_engine_matches_numpy_oracle(cuda_device, kind):
    store = _store(np.random.default_rng(23), True, kind=kind, n_records=2, n_docs=16, rec_len=3000)
    oracle = JaxEngine(store, backend="numpy")
    for backend in ("fused", "torch"):
        eng = QueryEngine(store, backend=backend, device=cuda_device)
        for rec, qs, qe in [("chr0", 0, 3000), ("chr1", 123, 2456), ("chr1", 2999, 3000)]:
            for k in (1, 3, 31, 101):
                got = getattr(eng, kind)(rec, qs, qe, k)
                np.testing.assert_array_equal(got, getattr(oracle, kind)(rec, qs, qe, k))
