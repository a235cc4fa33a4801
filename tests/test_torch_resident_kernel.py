"""ResidentShardedQuery on the fused engine, on the CPU: a whole-record
dispatch answers from the rank's placed rows through the fused kernels'
wrappers (their plain version here) and never builds the diff-array count
plane (``query_ops.coverage_counts`` / ``coverage_marks``). It stays exact
against memo_tpu's ResidentShardedQuery (on the conftest's virtual CPU
mesh) and memo_tpu's numpy engine: ``record=``, ``records=`` with records
shorter than the slab, a record with no rows, membership, k = 1, 31 and
k_max, and slabs that span several engine windows. rows_per_shard and
stats() stay memo_tpu's. A cuda-marked test holds the launches on the card."""

import jax
import numpy as np
import pytest
import torch

from memo_tpu.index.builder import store_from_ms
from memo_tpu.parallel import ResidentShardedQuery as JaxResident
from memo_tpu.parallel import make_mesh
from memo_tpu.index.store import IntervalStore as JaxStore
from memo_tpu.query.engine import QueryEngine as JaxEngine
from memo_tpu_torch.index.placement import Columns
from memo_tpu_torch.ops import query_ops
from memo_tpu_torch.parallel import ResidentShardedQuery
from memo_tpu_torch.query import engine as engine_mod
from memo_tpu_torch.query.engine import QueryEngine

K_MAX = 64
REC_LEN = 700
WINDOWS = [(0, REC_LEN), (37, 229), (REC_LEN - 1, REC_LEN), (0, 1), (300, 644)]
MULTI = {"r0": 97, "r1": 300, "r2": 159}  # r0 and r2 are shorter than the slab (300)


def _ms(rng, length, n_cols, high=90):
    """Random MS columns under the matching-statistics law, some values long
    enough that their rows never mark at k <= K_MAX."""
    ms = rng.integers(0, high, size=(length, n_cols)).astype(np.int64)
    idx = np.arange(length, dtype=np.int64)[:, None]
    return (np.minimum.accumulate((ms + idx)[::-1])[::-1] - idx).astype(np.int32)


@pytest.fixture(scope="module")
def stores():
    rng = np.random.default_rng(31)
    cons = store_from_ms([_ms(rng, REC_LEN, 5)], ["chr0"], [REC_LEN], 6, "conservation")
    memb = store_from_ms([_ms(rng, REC_LEN, 5)], ["chr0"], [REC_LEN], 6, "membership")
    multi = store_from_ms([_ms(rng, n, 4) for n in MULTI.values()], list(MULTI),
                          list(MULTI.values()), 5, "conservation")
    return {"conservation": cons, "membership": memb, "multi": multi}


@pytest.fixture(scope="module")
def jax_resident(stores):
    """memo_tpu's resident strategy on sp=4 (record=) and a 2 x 2 mesh
    (records=) of the virtual CPU devices."""
    devs = jax.devices()[:4]
    out = {kind: JaxResident(stores[kind], make_mesh(dp=1, sp=4, devices=devs), k_max=K_MAX)
           for kind in ("conservation", "membership")}
    out["multi"] = JaxResident(stores["multi"], make_mesh(dp=2, sp=2, devices=devs),
                               records=list(MULTI), k_max=K_MAX)
    return out


@pytest.fixture
def no_count_plane(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the resident path built a diff-array count plane")

    monkeypatch.setattr(query_ops, "coverage_counts", refuse)
    monkeypatch.setattr(query_ops, "coverage_marks", refuse)


@pytest.fixture
def kernel_calls(monkeypatch):
    """Calls of each fused kernel wrapper through the engine."""
    calls = {"v1": 0, "v2": 0}
    for version, name in (("v1", "fused_query_rows"), ("v2", "fused_query_v2_rows")):
        def counted(*args, _run=getattr(engine_mod, name), _v=version, **kwargs):
            calls[_v] += 1
            return _run(*args, **kwargs)

        monkeypatch.setattr(engine_mod, name, counted)
    return calls


@pytest.mark.parametrize("version", ["v1", "v2"])
@pytest.mark.parametrize("kind", ["conservation", "membership"])
@pytest.mark.parametrize("k", [1, 31, K_MAX])
def test_record_matches_jax_and_numpy(stores, jax_resident, no_count_plane, kernel_calls,
                                      monkeypatch, version, kind, k):
    monkeypatch.setenv("MEMO_TPU_PALLAS_KERNEL", version)
    store = stores[kind]
    rq = ResidentShardedQuery(store, "cpu", k_max=K_MAX)
    oracle = JaxEngine(store, backend="numpy")
    got_all = getattr(rq, f"{kind}_windows")(WINDOWS, k)
    want_all = getattr(jax_resident[kind], f"{kind}_windows")(WINDOWS, k)
    for (qs, qe), got, want in zip(WINDOWS, got_all, want_all):
        assert got.dtype == (np.int8 if kind == "membership" else np.int32)
        np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(got, getattr(oracle, kind)("chr0", qs, qe, k))
    # One dispatch: one launch of the chosen kernel over the whole record.
    assert rq.dispatch_count == 1
    assert kernel_calls == {"v1": int(version == "v1"), "v2": int(version == "v2")}


@pytest.mark.parametrize("version", ["v1", "v2"])
@pytest.mark.parametrize("kind", ["conservation", "membership"])
def test_records_shorter_than_slab(stores, jax_resident, no_count_plane, kernel_calls,
                                   monkeypatch, version, kind):
    """Each record is served from one dispatch, one launch per record; the
    slab positions past a record's end hold the unmarked value and never
    reach a caller."""
    monkeypatch.setenv("MEMO_TPU_PALLAS_KERNEL", version)
    store = stores["multi"]
    rq = ResidentShardedQuery(store, "cpu", records=list(MULTI), k_max=K_MAX)
    oracle = JaxEngine(store, backend="numpy")
    for k in (2, 31):
        for name, length in MULTI.items():
            for qs, qe in ((0, length), (5, length - 3), (length - 1, length)):
                got = getattr(rq, kind)(qs, qe, k, record=name)
                want = getattr(jax_resident["multi"], kind)(qs, qe, k, record=name)
                np.testing.assert_array_equal(got, np.asarray(want))
                np.testing.assert_array_equal(got, getattr(oracle, kind)(name, qs, qe, k))
    assert rq.dispatch_count == 2
    assert kernel_calls[version] == 2 * len(MULTI)
    full = rq._full(31, kind == "membership")  # [n_batch, dp, B(, C)]
    assert full.shape[:3] == (len(MULTI), 1, max(MULTI.values()))
    unmarked = 1 if kind == "membership" else store.n_docs
    for i, length in enumerate(MULTI.values()):
        assert bool((full[i, 0, length:] == unmarked).all())


@pytest.mark.parametrize("kind", ["conservation", "membership"])
@pytest.mark.parametrize("chunk", [64, 128, 1000])
def test_slab_spans_several_engine_windows(stores, no_count_plane, kernel_calls, kind, chunk):
    """A slab longer than the engine's chunk is one batch of windows of at
    most ``chunk_positions`` (the last one shorter): still one launch."""
    store = stores[kind]
    rq = ResidentShardedQuery(store, "cpu", k_max=K_MAX, device_output=True)
    rq.engine.chunk_positions = chunk
    oracle = JaxEngine(store, backend="numpy")
    for k in (1, 31):
        full = getattr(rq, f"{kind}_full")(k)
        assert isinstance(full, torch.Tensor) and full.shape[0] == REC_LEN
        np.testing.assert_array_equal(full.numpy(), getattr(oracle, kind)("chr0", 0, REC_LEN, k))
    assert kernel_calls["v1"] + kernel_calls["v2"] == 2


def test_record_without_rows_is_unmarked(no_count_plane):
    """A record with no intervals answers the unmarked value beside one
    that has rows, as the numpy engine does."""
    rng = np.random.default_rng(41)
    store = store_from_ms([_ms(rng, 120, 4), np.zeros((0, 4), np.int32)], ["a", "b"], [120, 80],
                          5, "conservation")
    assert store.rec_offsets[1] == store.rec_offsets[2]
    rq = ResidentShardedQuery(store, "cpu", records=["b", "a"], k_max=K_MAX)
    oracle = JaxEngine(store, backend="numpy")
    for name, length in (("a", 120), ("b", 80)):
        np.testing.assert_array_equal(rq.conservation(0, length, 31, record=name),
                                      oracle.conservation(name, 0, length, 31))
        np.testing.assert_array_equal(rq.membership(3, length, 7, record=name),
                                      oracle.membership(name, 3, length, 7))
    assert rq.local_rows == int(((store.end - store.start) < K_MAX - 1).sum())


@pytest.mark.parametrize("kind", ["conservation", "multi"])
def test_rows_per_shard_and_stats_are_memo_tpus(stores, kind):
    """The placement filter and memo_tpu's padded width M, on the 1 x 1
    layout both packages take: stats() equals memo_tpu's on every key it
    has, and the engine holds exactly the rank's rows."""
    store = stores[kind]
    placement = {"records": list(MULTI)} if kind == "multi" else {}
    rq = ResidentShardedQuery(store, "cpu", k_max=K_MAX, **placement)
    ref = JaxResident(store, make_mesh(dp=1, sp=1, devices=jax.devices()[:1]), k_max=K_MAX,
                      **placement)
    mine = rq.stats()
    for key, value in ref.stats().items():
        assert mine[key] == value, key
    long_rows = int(((store.end - store.start) >= K_MAX - 1).sum())
    assert 0 < long_rows and rq.local_rows == store.num_intervals - long_rows
    # The engine's placed rows, read back here only: the store's rows less the long ones.
    keep = (store.end - store.start) < K_MAX - 1
    lay, n = rq.engine._layout, rq.local_rows
    assert rq.engine._children is None and lay.num_rows == n
    np.testing.assert_array_equal(rq.engine._d.start[:n].numpy(), store.start[keep])
    np.testing.assert_array_equal(
        lay.rec_offsets, np.concatenate([[0], np.cumsum(np.bincount(store.rec_id[keep],
                                                                    minlength=store.num_records))]))
    assert rq.rows_per_shard == ref.rows_per_shard


def test_cached_dispatch_launches_nothing(stores, kernel_calls):
    """Windows of a cached (k, mode) are slices of the memoized output: no
    launch; a new (k, mode) is one launch, and the LRU keeps 4 entries."""
    rq = ResidentShardedQuery(stores["conservation"], "cpu", k_max=K_MAX)
    rq.conservation_windows(WINDOWS, 9)
    rq.conservation(0, 10, 9)
    assert kernel_calls["v1"] == 1 and rq.dispatch_count == 1
    for k in (2, 3, 4, 5):
        rq.conservation(0, 10, k)
    assert kernel_calls["v1"] == 5 and len(rq._full_cache) == 4
    rq.conservation(0, 10, 9)  # evicted: computed again
    assert kernel_calls["v1"] == 6 and rq.dispatch_count == 6


class _SubsetEngine(QueryEngine):
    """A fused engine over given rows of the store, as resident's ranks
    build theirs."""

    def __init__(self, store, rows, **kwargs):
        self._given = rows
        super().__init__(store, backend="fused", device="cpu", device_output=True, **kwargs)

    def _upload(self, store):
        return self._given


@pytest.mark.parametrize("stratify", [False, True], ids=["whole", "stratified"])
@pytest.mark.parametrize("kind", ["conservation", "membership"])
def test_engine_over_a_subset_of_rows(stores, no_count_plane, kernel_calls, stratify, kind):
    """An engine placed from a subset of the store's rows already on the
    device answers as the numpy engine over that sub-store, whole or in
    length buckets (several of which mark at k=60: their batch outputs are
    min-combined as one tensor); unstratified, its placed rows, record
    offsets and longest intervals are the subset's."""
    store = stores[kind]
    keep = np.flatnonzero((store.end - store.start) % 3 != 0)
    cols = (store.rec_id, store.start, store.end, store.order)
    sub = JaxStore(record_names=store.record_names, record_lens=store.record_lens,
                   n_docs=store.n_docs, kind=kind, rec_id=cols[0][keep], start=cols[1][keep],
                   end=cols[2][keep], order=cols[3][keep])
    eng = _SubsetEngine(store, Columns(*(torch.from_numpy(a[keep]) for a in cols)),
                        stratify=stratify)
    oracle = JaxEngine(sub, backend="numpy")
    assert (eng._children is not None) == stratify
    if stratify:
        assert sum(c._layout.num_rows for _, c in eng._children) == keep.size
        assert len([lb for lb, _ in eng._children if lb < 60 - 1]) > 1
    else:
        n = eng._layout.num_rows
        for name, got in zip(("start", "end", "order"), eng._d[:3]):
            np.testing.assert_array_equal(got[:n].numpy(), getattr(sub, name))
        np.testing.assert_array_equal(eng._layout.rec_offsets, sub.rec_offsets)
        np.testing.assert_array_equal(eng._layout.longest, sub.max_interval_len)
    for k in (1, 5, 31, 60):
        launches = sum(kernel_calls.values())
        outs = getattr(eng, f"{kind}_batch")("chr0", WINDOWS, k)
        live = sum(lb < k - 1 for lb, _ in eng._children) if stratify else 1
        assert sum(kernel_calls.values()) == launches + live
        for (qs, qe), got in zip(WINDOWS, outs):
            np.testing.assert_array_equal(got.numpy(), getattr(oracle, kind)("chr0", qs, qe, k))


@pytest.mark.parametrize("kind", ["conservation", "membership"])
def test_slab_is_the_batch_output(stores, monkeypatch, kind):
    """The whole-record output of ``record=`` on one rank is the engine's
    batch tensor itself, read as positions: no second copy of it."""
    batches = []
    batch_tensor = QueryEngine._batch_tensor

    def kept(self, *args):
        batches.append(batch_tensor(self, *args))
        return batches[-1]

    monkeypatch.setattr(QueryEngine, "_batch_tensor", kept)
    rq = ResidentShardedQuery(stores[kind], "cpu", k_max=K_MAX, device_output=True)
    full = getattr(rq, f"{kind}_full")(31)
    assert len(batches) == 1 and full.data_ptr() == batches[0].out.data_ptr()


def test_rows_per_shard_is_computed_on_first_use(stores):
    """rows_per_shard (memo_tpu's nominal width) costs the placement
    nothing; stats() reports it beside the bytes the rank really placed."""
    rq = ResidentShardedQuery(stores["multi"], "cpu", records=list(MULTI), k_max=K_MAX)
    assert "rows_per_shard" not in vars(rq)
    stats = rq.stats()
    assert "rows_per_shard" in vars(rq) and stats["rows_per_shard"] == rq.rows_per_shard
    placed = (*rq.engine._d, *rq.engine._layout.device_tensors())
    assert stats["placed_bytes"] == sum(t.numel() * t.element_size() for t in placed)
    assert stats["placed_bytes"] >= rq.local_rows * 6 * 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused backend launches its kernels there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("version", ["v1", "v2"])
@pytest.mark.parametrize("kind", ["conservation", "membership"])
def test_cuda_resident_launches_the_kernel(stores, cuda_device, no_count_plane, monkeypatch,
                                           version, kind):
    from memo_tpu_torch.ops.fused_query import fused_query_rows
    from memo_tpu_torch.ops.fused_query_v2 import fused_query_v2_rows

    monkeypatch.setenv("MEMO_TPU_PALLAS_KERNEL", version)
    run = fused_query_rows if version == "v1" else fused_query_v2_rows
    store = stores[kind]
    rq = ResidentShardedQuery(store, cuda_device, k_max=K_MAX)
    oracle = JaxEngine(store, backend="numpy")
    for k in (1, 31, K_MAX):
        before = run.launches
        outs = getattr(rq, f"{kind}_windows")(WINDOWS, k)
        assert run.launches == before + 1
        for (qs, qe), got in zip(WINDOWS, outs):
            np.testing.assert_array_equal(got, getattr(oracle, kind)("chr0", qs, qe, k))
