"""memo_tpu_torch.parallel on one device (the CPU here), held exactly
against memo_tpu.parallel on the conftest's 8-device virtual CPU mesh and
against memo_tpu's numpy engine: ShardedQuery (position and interval) and
ResidentShardedQuery (record=, records=, the placement-time k_max filter,
the LRU of whole-record outputs and the k range)."""

import jax
import numpy as np
import pytest
import torch

from memo_tpu.index.builder import store_from_ms
from memo_tpu.index.store import IntervalStore
from memo_tpu.parallel import ResidentShardedQuery as JaxResident
from memo_tpu.parallel import ShardedQuery as JaxSharded
from memo_tpu.parallel import make_mesh
from memo_tpu.query.engine import QueryEngine as JaxEngine
from memo_tpu_torch.parallel import ResidentShardedQuery, ShardedQuery, check_layout, initialize
from memo_tpu_torch.parallel import make_mesh as make_torch_mesh


def _random_store(rng, n_records=2, n_docs=5, rec_len=400, kind="conservation"):
    ms = [rng.integers(0, 40, size=(rec_len, n_docs - 1)).astype(np.int32) for _ in range(n_records)]
    return store_from_ms(ms, [f"chr{i}" for i in range(n_records)], [rec_len] * n_records, n_docs,
                         kind)


@pytest.fixture(scope="module")
def store():
    return _random_store(np.random.default_rng(7))


@pytest.fixture(scope="module")
def memb_store():
    return _random_store(np.random.default_rng(8), kind="membership")


WINDOWS = [("chr0", 0, 400), ("chr0", 37, 229), ("chr1", 100, 400), ("chr1", 0, 64),
           ("chr1", 399, 400)]


@pytest.mark.parametrize("strategy", ["position", "interval"])
@pytest.mark.parametrize("k", [1, 3, 31])
def test_sharded_conservation_matches_jax_and_numpy(store, strategy, k):
    got = ShardedQuery(store, "cpu", strategy=strategy).conservation(WINDOWS, k)
    ref = JaxSharded(store, make_mesh(dp=2, sp=4), strategy=strategy).conservation(WINDOWS[:4], k)
    oracle = JaxEngine(store, backend="numpy")
    for i, ((rec, qs, qe), g) in enumerate(zip(WINDOWS, got)):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, oracle.conservation(rec, qs, qe, k))
        if i < len(ref):
            np.testing.assert_array_equal(g, np.asarray(ref[i]))


@pytest.mark.parametrize("strategy", ["position", "interval"])
def test_sharded_membership_matches_jax_and_numpy(memb_store, strategy):
    got = ShardedQuery(memb_store, "cpu", strategy=strategy).membership(WINDOWS[:4], 5)
    ref = JaxSharded(memb_store, make_mesh(dp=2, sp=4), strategy=strategy).membership(WINDOWS[:4], 5)
    oracle = JaxEngine(memb_store, backend="numpy")
    for (rec, qs, qe), g, r in zip(WINDOWS, got, ref):
        assert g.dtype == np.int8
        np.testing.assert_array_equal(g, np.asarray(r))
        np.testing.assert_array_equal(g, oracle.membership(rec, qs, qe, 5))


def test_sharded_skewed_buckets():
    """Windows with very different candidate counts land in different pow2
    buckets and stay exact (test_parallel.py::test_skewed_batch_buckets)."""
    rng = np.random.default_rng(11)
    dense = rng.integers(0, 60, size=(512, 4)).astype(np.int32)
    sparse = np.zeros((512, 4), np.int32)
    sparse[::97] = 3
    st = store_from_ms([dense, sparse], ["chr0", "chr1"], [512, 512], 5, "conservation")
    windows = [("chr0", 0, 512), ("chr1", 0, 512), ("chr1", 64, 256), ("chr0", 8, 136)]
    sq = ShardedQuery(st, "cpu")
    rows = sq._window_rows(windows, 3)
    assert len({1 if hi - lo <= 1 else 1 << (hi - lo - 1).bit_length() for lo, hi in rows}) > 1
    oracle = JaxEngine(st, backend="numpy")
    for (rec, qs, qe), g in zip(windows, sq.conservation(windows, 3)):
        np.testing.assert_array_equal(g, oracle.conservation(rec, qs, qe, 3))


def test_sharded_empty_and_errors(store):
    assert ShardedQuery(store, "cpu").conservation([], 3) == []
    with pytest.raises(ValueError, match="unknown strategy"):
        ShardedQuery(store, "cpu", strategy="resident")


@pytest.mark.parametrize("layout", [(1, 1), ("1", "1")])
def test_check_layout_accepts_one_device(layout):
    assert check_layout(layout) == (1, 1)


@pytest.mark.parametrize("layout", [(2, 1), (1, 2), (4, 2)])
def test_check_layout_refuses_other_layouts(layout):
    """Without a process group only the one-device layout runs; any other
    raises and says how to launch one process per device."""
    with pytest.raises(ValueError, match="no process group exists.*torchrun --nproc-per-node"):
        check_layout(layout)


def test_make_mesh_without_group_is_one_device(store):
    """Without a process group the mesh is the in-process 1 x 1 layout, and a
    device in the mesh's place means that layout on it."""
    mesh = make_torch_mesh(device_type="cpu")
    assert mesh.shape == {"dp": 1, "sp": 1} and mesh.device_mesh is None
    for where in (mesh, "cpu"):
        sq = ShardedQuery(store, where, strategy="interval")
        assert sq.mesh.shape == {"dp": 1, "sp": 1} and sq.device.type == "cpu"
    with pytest.raises(ValueError, match="torchrun"):
        make_torch_mesh(2, 2, device_type="cpu")


def test_initialize_cuda_without_gpu_raises(monkeypatch):
    """A CUDA group where there is no GPU raises; nothing joins with gloo instead."""
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize("localhost:1", 1, 0, device="cuda")
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def one_record():
    return _random_store(np.random.default_rng(17), n_records=1)


@pytest.mark.parametrize("k", [1, 3, 31, 101])
def test_resident_record_matches_jax_and_numpy(one_record, k):
    rq = ResidentShardedQuery(one_record, "cpu", k_max=128)
    ref = JaxResident(one_record, make_mesh(dp=1, sp=8), k_max=128)
    oracle = JaxEngine(one_record, backend="numpy")
    for qs, qe in [(0, 400), (37, 229), (399, 400), (0, 1)]:
        got = rq.conservation(qs, qe, k)
        np.testing.assert_array_equal(got, np.asarray(ref.conservation(qs, qe, k)))
        np.testing.assert_array_equal(got, oracle.conservation("chr0", qs, qe, k))


def test_resident_membership_and_windows(memb_store):
    rq = ResidentShardedQuery(memb_store, "cpu", record="chr1", k_max=64)
    ref = JaxResident(memb_store, make_mesh(dp=1, sp=4, devices=jax.devices()[:4]), record="chr1",
                      k_max=64)
    oracle = JaxEngine(memb_store, backend="numpy")
    windows = [(0, 100), (50, 399), (200, 201)]
    for (qs, qe), got, want in zip(windows, rq.membership_windows(windows, 9),
                                   ref.membership_windows(windows, 9)):
        assert got.dtype == np.int8
        np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(got, oracle.membership("chr1", qs, qe, 9))
    for (qs, qe), got in zip(windows, rq.conservation_windows(windows, 9)):
        np.testing.assert_array_equal(got, oracle.conservation("chr1", qs, qe, 9))


def test_resident_records_placement_matches_jax(store):
    """records= (and a multi-record store with neither record= nor
    records=) serves every record from one dispatch per (k, mode)."""
    lens = [97, 128, 159]
    rng = np.random.default_rng(23)
    ms = [rng.integers(0, 25, size=(ln, 4)).astype(np.int32) for ln in lens]
    names = ["r0", "r1", "r2"]
    st = store_from_ms(ms, names, lens, 5, "conservation")
    rq = ResidentShardedQuery(st, "cpu", records=names, k_max=64)
    auto = ResidentShardedQuery(st, "cpu", k_max=64)
    assert auto.records == names
    ref = JaxResident(st, make_mesh(dp=2, sp=2, devices=jax.devices()[:4]), records=names, k_max=64)
    oracle = JaxEngine(st, backend="numpy")
    for k in (2, 31):
        for name, ln in zip(names, lens):
            got = rq.conservation(0, ln, k, record=name)
            np.testing.assert_array_equal(got, np.asarray(ref.conservation(0, ln, k, record=name)))
            np.testing.assert_array_equal(got, oracle.conservation(name, 0, ln, k))
            np.testing.assert_array_equal(auto.conservation(5, ln - 3, k, record=name),
                                          oracle.conservation(name, 5, ln - 3, k))
    assert rq.dispatch_count == 2  # one per k, every record served
    with pytest.raises(ValueError, match="record"):
        rq.conservation(0, 10, 7)
    with pytest.raises(KeyError):
        rq.conservation(0, 10, 7, record="nope")
    with pytest.raises(ValueError, match="not both"):
        ResidentShardedQuery(st, "cpu", record="r0", records=names)
    with pytest.raises(ValueError, match="duplicate"):
        ResidentShardedQuery(st, "cpu", records=["r0", "r0"])
    stats = rq.stats()
    assert stats["records"] == names and stats["dp_slots"] == 3 and stats["shards"] == 1
    assert stats["slab_positions"] == max(lens)


def test_resident_placement_length_filter():
    """Rows with length >= k_max-1 are dropped at placement; outputs stay
    exact for every k <= k_max (test_resident.py::test_resident_placement_length_filter)."""
    rng = np.random.default_rng(23)
    L, n_iv, n = 300, 600, 5
    starts = np.sort(rng.integers(0, L, n_iv)).astype(np.int64)
    long = rng.random(n_iv) < 0.8
    lens = np.where(long, rng.integers(63, 200, n_iv), rng.integers(0, 40, n_iv))
    st = IntervalStore(record_names=["c"], record_lens=[L], n_docs=n, kind="conservation",
                       rec_id=np.zeros(n_iv, np.int32), start=starts, end=starts + lens,
                       order=rng.integers(1, n, n_iv).astype(np.int64))
    rq = ResidentShardedQuery(st, "cpu", k_max=64)
    assert rq.rows_per_shard == -(-int((lens < 63).sum()) // 8) * 8 < n_iv
    assert rq.rows_per_shard == JaxResident(st, make_mesh(dp=1, sp=1, devices=jax.devices()[:1]),
                                            k_max=64).rows_per_shard
    oracle = JaxEngine(st, backend="numpy")
    for k in (1, 2, 31, 64):
        np.testing.assert_array_equal(rq.conservation(0, L, k), oracle.conservation("c", 0, L, k))


def test_resident_lru_dispatch_count_and_k_range(one_record):
    rq = ResidentShardedQuery(one_record, "cpu", k_max=64, device_output=True)
    windows = [(w, min(w + 40, 400)) for w in range(0, 400, 40)]
    for qs, qe in windows:
        assert isinstance(rq.conservation(qs, qe, 9), torch.Tensor)
    assert rq.dispatch_count == 1
    rq.conservation(0, 400, 31)
    rq.membership(0, 400, 9)
    rq.conservation_windows(windows, 9)
    assert rq.dispatch_count == 3  # distinct (k, mode) only
    for k in (2, 3):
        rq.conservation(0, 10, k)
    assert rq.dispatch_count == 5 and len(rq._full_cache) == 4
    rq.conservation(0, 10, 9)  # refreshed by the windows call: still cached
    assert rq.dispatch_count == 5
    rq.conservation(0, 10, 31)  # the least recently used entry: evicted, computed again
    assert rq.dispatch_count == 6
    for k in (0, 65):
        with pytest.raises(ValueError, match="k_max"):
            rq.conservation(0, 10, k)


def test_resident_refuses_end_before_start():
    st = IntervalStore(record_names=["c"], record_lens=[50], n_docs=3, kind="conservation",
                       rec_id=np.zeros(2, np.int32), start=np.array([5, 9]), end=np.array([7, 8]),
                       order=np.array([1, 2]))
    with pytest.raises(ValueError, match="end < start"):
        ResidentShardedQuery(st, "cpu")
