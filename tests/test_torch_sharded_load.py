"""ShardedQuery (position and interval) on a loaded index, on the CPU: each
rank places the start, end and order columns on its device once (a loaded
store's streamed from the ``.npz``, ``upload_columns``), finds each window's
candidate rows there with ``torch.searchsorted``, gathers each bucket's rows
there, and brings every window's output to the host in one copy and one
wait. With numpy's member reader refusing any array over R + 1 elements,
for stored and deflated files written by either package: the outputs equal
memo_tpu's ShardedQuery on a one-device mesh and memo_tpu's numpy engine at
k = 3, 31 and 51, conservation and membership, with windows over several
records, at a record's end, in buckets of different widths, of unequal
lengths and on a record with no rows; no column is read on the host; the
row ranges equal memo_tpu's; the CLI's ``--regions-file --strategy
position|interval`` writes memo_tpu's bytes; ResidentShardedQuery's
``rows_per_shard`` equals memo_tpu's. Tolerance: exact (integers and
bytes)."""

import numpy as np
import pytest
import torch

import jax
from memo_tpu import cli as ref_cli
from memo_tpu.index.builder import store_from_ms
from memo_tpu.parallel import ResidentShardedQuery as JaxResident
from memo_tpu.parallel import ShardedQuery as JaxSharded
from memo_tpu.parallel import make_mesh
from memo_tpu.query.engine import QueryEngine as JaxEngine
from memo_tpu_torch import cli
from memo_tpu_torch.index import npz as npz_mod
from memo_tpu_torch.index.store import COLUMNS, IntervalStore
from memo_tpu_torch.parallel import ResidentShardedQuery, ShardedQuery
from memo_tpu_torch.query import engine as engine_mod

KS = (3, 31, 51)
MODES = ("conservation", "membership")
STRATEGIES = ("position", "interval")
WRITERS = ["memo_tpu", "port_deflated", "port_stored"]
LENS = {"dense": 512, "sparse": 512, "empty": 80, "r3": 301}  # "empty" holds no row
WINDOWS = [("dense", 0, 512), ("sparse", 0, 512), ("sparse", 64, 256), ("dense", 8, 137),
           ("r3", 290, 301), ("dense", 505, 512), ("empty", 3, 40), ("r3", 0, 1),
           ("dense", 100, 101), ("r3", 17, 300)]


def _stores() -> dict:
    """Four records, conservation and membership: one dense, one sparse
    (their windows fall in buckets of different widths), one without rows
    and one shorter than the rest."""
    rng = np.random.default_rng(23)
    out = {}
    for kind in MODES:
        dense = rng.integers(0, 60, size=(512, 5)).astype(np.int32)
        sparse = np.zeros((512, 5), np.int32)
        sparse[::97] = 3
        ms = [dense, sparse, np.zeros((0, 5), np.int32),
              rng.integers(0, 40, size=(301, 5)).astype(np.int32)]
        out[kind] = store_from_ms(ms, list(LENS), list(LENS.values()), 6, kind)
    return out


STORES = _stores()


def _save(store, writer: str, path) -> None:
    if writer == "memo_tpu":
        store.save(path)
    else:
        IntervalStore(record_names=store.record_names, record_lens=store.record_lens,
                      n_docs=store.n_docs, kind=store.kind, rec_id=store.rec_id,
                      start=store.start, end=store.end,
                      order=store.order).save(path, compressed=writer == "port_deflated")


@pytest.fixture
def small_reads_only(monkeypatch):
    """``refuse(R)``: from then on, numpy's member reader refuses any array
    over R + 1 elements."""
    real = np.lib.format.read_array

    def refuse(n_records: int) -> None:
        def small_only(*args, **kwargs):
            arr = real(*args, **kwargs)
            if arr.size > n_records + 1:
                raise AssertionError(f"numpy's reader read an array of {arr.size} elements")
            return arr

        monkeypatch.setattr(np.lib.format, "read_array", small_only)

    return refuse


@pytest.fixture(scope="module")
def memo_tpu_outputs():
    """{(mode, strategy, k): memo_tpu's ShardedQuery outputs on a one-device
    mesh}, and {(mode, k): its numpy engine's}, each computed once."""
    mesh = make_mesh(dp=1, sp=1, devices=jax.devices()[:1])
    sharded, numpy_engine = {}, {}
    for mode in MODES:
        store = STORES[mode]
        oracle = JaxEngine(store, backend="numpy")
        for k in KS:
            numpy_engine[mode, k] = [getattr(oracle, mode)(*w, k) for w in WINDOWS]
            for strategy in STRATEGIES:
                sq = JaxSharded(store, mesh, strategy=strategy)
                sharded[mode, strategy, k] = [np.asarray(o) for o in getattr(sq, mode)(WINDOWS, k)]
    return sharded, numpy_engine


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("writer", WRITERS)
def test_loaded_store_equals_memo_tpu(tmp_path, monkeypatch, small_reads_only, memo_tpu_outputs,
                                      writer, strategy, mode):
    """Set-up and queries at k = 3, 31 and 51 from the loaded file (staging
    chunks of 4 KB), no column read on the host: == memo_tpu's ShardedQuery
    and its numpy engine, window for window, dtype too."""
    monkeypatch.setattr(npz_mod, "CHUNK_BYTES", 4096)
    store = STORES[mode]
    path = tmp_path / "idx.npz"
    _save(store, writer, path)
    small_reads_only(store.num_records)
    loaded = IntervalStore.load(path)
    sq = ShardedQuery(loaded, "cpu", strategy=strategy)
    sharded, numpy_engine = memo_tpu_outputs
    for k in KS:
        got = getattr(sq, mode)(WINDOWS, k)
        assert len(got) == len(WINDOWS)
        for w, g, ref, oracle in zip(WINDOWS, got, sharded[mode, strategy, k],
                                     numpy_engine[mode, k]):
            assert g.dtype == ref.dtype == (np.int8 if mode == "membership" else np.int32), w
            np.testing.assert_array_equal(g, ref, err_msg=f"{w} k={k} vs memo_tpu")
            np.testing.assert_array_equal(g, oracle, err_msg=f"{w} k={k} vs numpy engine")
    assert loaded.file_columns()[1] == list(COLUMNS)  # no column read on the host


@pytest.mark.parametrize("k", KS)
def test_window_rows_equal_memo_tpus(k):
    """The row ranges found on the device == memo_tpu's host search, for
    windows over every record: a window at a record's end reaches that
    record's last row and no further, an empty record's are empty, and the
    windows land in more than one pow2 bucket."""
    store = STORES["conservation"]
    got = ShardedQuery(store, "cpu")._window_rows(WINDOWS, k)
    want = JaxSharded(store, make_mesh(dp=1, sp=1, devices=jax.devices()[:1]))._window_rows(
        WINDOWS, k)
    assert got == [tuple(map(int, w)) for w in want]
    assert all(isinstance(x, int) for pair in got for x in pair)
    ends = {name: int(store.rec_offsets[i + 1]) for i, name in enumerate(LENS)}
    assert got[WINDOWS.index(("dense", 505, 512))][1] == ends["dense"]
    assert got[WINDOWS.index(("r3", 290, 301))][1] == ends["r3"]
    lo, hi = got[WINDOWS.index(("empty", 3, 40))]
    assert lo == hi == ends["empty"]
    widths = {1 if hi - lo <= 1 else 1 << (hi - lo - 1).bit_length() for lo, hi in got}
    assert len(widths) > 2


def test_placement_holds_three_int32_columns_and_a_pad_row():
    """The rank's device holds start, end and order as int32 in store
    order, and one pad row (0, 0, -1); not rec_id."""
    store = STORES["conservation"]
    sq = ShardedQuery(store, "cpu", strategy="interval")
    for placed, host, pad in ((sq._start, store.start, 0), (sq._end, store.end, 0),
                              (sq._order, store.order, -1)):
        assert placed.dtype == torch.int32 and placed.numel() == store.num_intervals + 1
        assert np.array_equal(placed[:-1].numpy(), host) and int(placed[-1]) == pad
    assert not hasattr(sq, "_rec_id")


def test_coordinates_past_int32_raise():
    """A store whose coordinates do not fit the device's int32 rows raises
    at placement instead of wrapping."""
    store = STORES["conservation"]
    far = IntervalStore(record_names=store.record_names, record_lens=store.record_lens,
                        n_docs=store.n_docs, kind=store.kind, rec_id=store.rec_id,
                        start=store.start, end=store.end + (1 << 31), order=store.order)
    with pytest.raises(OverflowError, match="int32"):
        ShardedQuery(far, "cpu")


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("mode", MODES)
def test_outputs_come_back_in_one_copy_and_one_wait(monkeypatch, strategy, mode):
    """A call makes one copy of every bucket's outputs to the host
    (``engine._copy_back``) and one wait, whatever the number of buckets;
    nothing the query uploads is larger than the windows' row ranges (no
    array of candidate rows is built on the host); an empty window list
    copies nothing."""
    calls, uploads = [], []

    class Ready:
        def synchronize(self):
            calls.append("wait")

    def copy_back(t):
        calls.append(("copy", tuple(t.shape)))
        return t.clone(), Ready()

    real_from_numpy = torch.from_numpy

    def from_numpy(a):
        uploads.append(a.size)
        return real_from_numpy(a)

    monkeypatch.setattr(engine_mod, "_copy_back", copy_back)
    store = STORES[mode]
    sq = ShardedQuery(store, "cpu", strategy=strategy)
    monkeypatch.setattr(torch, "from_numpy", from_numpy)
    oracle = JaxEngine(store, backend="numpy")
    for k in KS:
        calls.clear()
        got = getattr(sq, mode)(WINDOWS, k)
        L = max(qe - qs for _, qs, qe in WINDOWS)
        assert [c if c == "wait" else c[0] for c in calls] == ["copy", "wait"]
        assert calls[0][1][:2] == (len(WINDOWS), L)
        for w, g in zip(WINDOWS, got):
            np.testing.assert_array_equal(g, getattr(oracle, mode)(*w, k))
    assert uploads and max(uploads) <= 2 * len(WINDOWS)
    calls.clear()
    assert getattr(sq, mode)([], 3) == [] and calls == []


@pytest.fixture(scope="module")
def memo_tpu_cli(tmp_path_factory):
    """memo_tpu's ``query --regions-file --strategy position`` outputs for
    each mode: {mode: (regions, {region: bytes})}."""
    out = {}
    for mode in MODES:
        tmp = tmp_path_factory.mktemp(f"ref_{mode}")
        path = tmp / "idx.npz"
        STORES[mode].save(path)
        regions = [f"{name}:{qs}-{qe}" for name, qs, qe in WINDOWS]
        (tmp / "regions.txt").write_text("\n".join(regions) + "\n")
        flags = ["-k", "31", "--regions-file", str(tmp / "regions.txt")]
        flags += ["-m"] if mode == "membership" else []
        assert ref_cli.main(["query", "-b", str(path), "-o", str(tmp / "want"), "--strategy",
                             "position", *flags]) == 0
        out[mode] = (tmp, flags, {r: (tmp / f"want.{_suffix(r)}").read_bytes() for r in regions})
    return out


def _suffix(region: str) -> str:
    return region.replace(":", "_").replace("-", "_") + ".txt"


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("writer", WRITERS)
def test_regions_file_writes_memo_tpus_bytes(tmp_path, small_reads_only, memo_tpu_cli, writer,
                                             strategy, mode):
    """``query --regions-file --strategy position|interval`` on the loaded
    file, with numpy's reader refusing the columns, writes region for
    region the bytes memo_tpu's ``--strategy position`` writes."""
    store = STORES[mode]
    path = tmp_path / "idx.npz"
    _save(store, writer, path)
    _, flags, want = memo_tpu_cli[mode]
    small_reads_only(store.num_records)
    assert cli.main(["query", "-b", str(path), "-o", str(tmp_path / "got"), "--strategy",
                     strategy, "--device", "cpu", *flags]) == 0
    for region, data in want.items():
        assert data and (tmp_path / f"got.{_suffix(region)}").read_bytes() == data, region


@pytest.mark.parametrize("writer", WRITERS)
def test_rows_per_shard_reads_no_host_column(tmp_path, small_reads_only, writer):
    """ResidentShardedQuery's ``rows_per_shard`` (and so ``stats()``) on a
    loaded store, with numpy's reader refusing the columns: == memo_tpu's,
    for ``records=`` and for ``record=``; no column is read on the host."""
    store = STORES["conservation"]
    path = tmp_path / "idx.npz"
    _save(store, writer, path)
    small_reads_only(store.num_records)
    mesh = make_mesh(dp=1, sp=1, devices=jax.devices()[:1])
    for placement in ({"records": list(LENS)}, {"record": "r3"}):
        loaded = IntervalStore.load(path)
        rq = ResidentShardedQuery(loaded, "cpu", k_max=64, **placement)
        ref = JaxResident(store, mesh, k_max=64, **placement)
        stats = rq.stats()
        assert stats["rows_per_shard"] == rq.rows_per_shard == ref.rows_per_shard, placement
        assert stats["resident_bytes_per_shard"] == ref.stats()["resident_bytes_per_shard"]
        assert loaded.file_columns()[1] == list(COLUMNS)
