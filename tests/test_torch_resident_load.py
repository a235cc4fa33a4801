"""ResidentShardedQuery on a loaded index, on the CPU: its set-up streams
each record's slab rows from the ``.npz`` to the device (``upload_columns``
with row ranges; ``index/npz.py`` reads a stored member at those rows only
and inflates a deflated one whole), finds the slab bounds without the host
start column (``start_rows``: a search in the file, or on the device) and
checks end >= start there. With numpy's member reader refusing any array
over R + 1 elements and the host columns never read, it equals memo_tpu's
ResidentShardedQuery and memo_tpu's numpy engine (``record=``,
``records=``, a record with no rows, slabs shorter than
``chunk_positions``, k = 1, 31 and k_max), and the CLI's ``--regions-file``
with ``auto`` (resolved to resident) writes memo_tpu's bytes, for stored and
deflated files written by either package. The streamed row ranges equal the
host slices across chunk edges; an end < start row raises memo_tpu's
ValueError; a corrupt member raises; and a ``*_windows`` call with host
output makes one copy back and one wait. Tolerance: exact (integers and
bytes)."""

import logging

import jax
import numpy as np
import pytest
import torch

from memo_tpu import cli as ref_cli
from memo_tpu.index.builder import store_from_ms
from memo_tpu.index.store import IntervalStore as RefStore
from memo_tpu.parallel import ResidentShardedQuery as JaxResident
from memo_tpu.parallel import make_mesh
from memo_tpu.query.engine import QueryEngine as JaxEngine
from memo_tpu_torch import cli
from memo_tpu_torch.index import npz as npz_mod
from memo_tpu_torch.index.placement import start_rows, upload_columns
from memo_tpu_torch.index.store import COLUMNS, IntervalStore
from memo_tpu_torch.parallel import ResidentShardedQuery
from memo_tpu_torch.query import engine as engine_mod

K_MAX = 64
KS = (1, 31, K_MAX)
MODES = ("conservation", "membership")
WRITERS = ["memo_tpu", "port_deflated", "port_stored"]
LENS = {"r0": 700, "r1": 97, "empty": 80, "r2": 300}  # "empty" holds no row
WINDOWS = {"r0": [(0, 700), (37, 229), (699, 700), (300, 644)], "r1": [(0, 97), (5, 94)],
           "empty": [(0, 80), (3, 9)], "r2": [(0, 300), (299, 300), (10, 11)]}


def _ms(rng, length, n_cols, high=90):
    """Random MS columns under the matching-statistics law, some long
    enough that their rows never mark at k <= K_MAX."""
    ms = rng.integers(0, high, size=(length, n_cols)).astype(np.int64)
    idx = np.arange(length, dtype=np.int64)[:, None]
    return (np.minimum.accumulate((ms + idx)[::-1])[::-1] - idx).astype(np.int32)


@pytest.fixture(scope="module")
def stores():
    """One record (conservation and membership) and four records, one of
    them without rows and the others shorter than the first."""
    rng = np.random.default_rng(57)
    one = {kind: store_from_ms([_ms(rng, 700, 5)], ["r0"], [700], 6, kind) for kind in MODES}
    ms = [_ms(rng, n, 4) if name != "empty" else np.zeros((0, 4), np.int32)
          for name, n in LENS.items()]
    multi = store_from_ms(ms, list(LENS), list(LENS.values()), 5, "conservation")
    assert multi.rec_offsets[2] == multi.rec_offsets[3]
    return one | {"records": multi}


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


def _placement(case: str) -> dict:
    return {"records": list(LENS)} if case == "records" else {}


@pytest.mark.parametrize("case", ["conservation", "membership", "records"])
@pytest.mark.parametrize("writer", WRITERS)
def test_loaded_store_equals_memo_tpu(stores, tmp_path, monkeypatch, small_reads_only, writer,
                                      case):
    """Set-up and both modes at k = 1, 31 and k_max from the loaded file
    (staging chunks of 4 KB), no host column read: == memo_tpu's
    ResidentShardedQuery (1 x 1 mesh) and its numpy engine, window for
    window, on ``record=`` and on ``records=`` (a record with no rows, and
    records shorter than the slab); every slab is shorter than the
    engine's ``chunk_positions``."""
    monkeypatch.setattr(npz_mod, "CHUNK_BYTES", 4096)
    store = stores[case]
    path = tmp_path / "idx.npz"
    _save(store, writer, path)
    small_reads_only(store.num_records)
    loaded = IntervalStore.load(path)
    rq = ResidentShardedQuery(loaded, "cpu", k_max=K_MAX, **_placement(case))
    assert rq.B < rq.engine.chunk_positions
    ref = JaxResident(store, make_mesh(dp=1, sp=1, devices=jax.devices()[:1]), k_max=K_MAX,
                      **_placement(case))
    oracle = JaxEngine(store, backend="numpy")
    names = list(LENS) if case == "records" else ["r0"]
    for mode in MODES:
        for k in KS:
            for name in names:
                got = getattr(rq, f"{mode}_windows")(WINDOWS[name], k, record=name)
                want = getattr(ref, f"{mode}_windows")(WINDOWS[name], k, record=name)
                for (qs, qe), g, w in zip(WINDOWS[name], got, want):
                    assert g.dtype == np.asarray(w).dtype, (mode, k, name)
                    np.testing.assert_array_equal(g, np.asarray(w))
                    np.testing.assert_array_equal(g, getattr(oracle, mode)(name, qs, qe, k))
    assert rq.dispatch_count == len(MODES) * len(KS)
    assert loaded.file_columns()[1] == list(COLUMNS)  # no column read on the host
    in_memory = ResidentShardedQuery(store, "cpu", k_max=K_MAX, **_placement(case))
    assert rq.local_rows == in_memory.local_rows
    for mine, theirs in zip(rq._placed(), in_memory._placed()):
        for a, b in zip(mine._d, theirs._d):
            assert torch.equal(a, b)


@pytest.mark.parametrize("membership", [False, True], ids=["conservation", "membership"])
@pytest.mark.parametrize("writer", WRITERS)
def test_regions_file_auto_writes_memo_tpus_bytes(stores, tmp_path, small_reads_only, caplog,
                                                  writer, membership):
    """``query --regions-file --strategy auto`` on the loaded file resolves
    to resident and writes, region for region, the bytes memo_tpu's
    ``--strategy position`` writes; regions of two records interleaved."""
    store = stores["membership"] if membership else stores["records"]
    path = tmp_path / "idx.npz"
    _save(store, writer, path)
    names = ["r0"] if membership else ["r0", "r2"]
    regions = [f"{name}:{qs}-{qe}" for qs_qe in zip(*(WINDOWS[n] for n in names))
               for name, (qs, qe) in zip(names, qs_qe)]
    regions_file = tmp_path / "regions.txt"
    regions_file.write_text("\n".join(regions) + "\n")
    flags = ["-k", "31", "--regions-file", str(regions_file)] + (["-m"] if membership else [])
    assert ref_cli.main(["query", "-b", str(path), "-o", str(tmp_path / "want"), "--strategy",
                         "position", *flags]) == 0
    small_reads_only(store.num_records)
    logger = logging.getLogger(cli.log.name)
    logger.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.INFO, logger=cli.log.name):
            assert cli.main(["query", "-b", str(path), "-o", str(tmp_path / "got"), "--device",
                             "cpu", *flags]) == 0
    finally:
        logger.removeHandler(caplog.handler)
    assert "--strategy auto resolved to 'resident'" in caplog.text
    for region in regions:
        suffix = region.replace(":", "_").replace("-", "_") + ".txt"
        want = (tmp_path / f"want.{suffix}").read_bytes()
        assert (tmp_path / f"got.{suffix}").read_bytes() == want and want, region


ROW_RANGES = [[(0, 5), (100, 413), (413, 700), (800, None)], [(37, 38)], [(0, None)], [],
              [(250, 250), (251, 903)]]


@pytest.mark.parametrize("chunk_bytes", [1000, 512])
@pytest.mark.parametrize("compressed", [False, True], ids=["stored", "deflated"])
def test_streamed_row_ranges_equal_host_slices(stores, tmp_path, monkeypatch, compressed,
                                               chunk_bytes):
    """Row ranges that start and end inside staging chunks, span several,
    meet end to end, are empty, or are the whole column (chunks of 1000
    bytes also cut elements): the streamed rows == the host slices,
    concatenated; ranges that are not ascending and disjoint raise."""
    store = stores["records"]
    n = store.num_intervals
    assert store.start.nbytes > 4 * chunk_bytes
    monkeypatch.setattr(npz_mod, "CHUNK_BYTES", chunk_bytes)
    path = tmp_path / "idx.npz"
    _save(store, "port_deflated" if compressed else "port_stored", path)
    for ranges in ROW_RANGES:
        ranges = [(lo, n if hi is None else hi) for lo, hi in ranges]
        loaded = IntervalStore.load(path)
        got = upload_columns(loaded, "cpu", ranges)
        assert loaded.file_columns()[1] == list(COLUMNS)
        for name, col in zip(COLUMNS, got):
            a = getattr(store, name)
            want = np.concatenate([a[lo:hi] for lo, hi in ranges] or [a[:0]])
            assert col.numpy().dtype == want.dtype and np.array_equal(col.numpy(), want), name
    for bad in ([(5, 3)], [(0, 10), (9, 20)], [(0, n + 1)], [(10, 20), (0, 5)]):
        with pytest.raises(ValueError, match="ascending"):
            upload_columns(IntervalStore.load(path), "cpu", bad)


@pytest.mark.parametrize("route", ["stored", "deflated", "host"])
def test_start_rows_equal_window_bounds(stores, tmp_path, route):
    """The slab bounds' search, in the file (stored), on the device
    (deflated) or on the host column: == ``window_bounds``'s searchsorted
    for values before, inside and past every record, the empty one too."""
    store = stores["records"]
    path = tmp_path / "idx.npz"
    _save(store, "port_deflated" if route == "deflated" else "port_stored", path)
    loaded = IntervalStore.load(path)
    if route == "host":
        loaded.start
    values = {r: [-1000, -1, 0, 1, 17, 96, 97, 299, 300, 699, 700, 10_000]
              for r in range(store.num_records)}
    got = start_rows(loaded, values, "cpu")
    for r, vs in values.items():
        lo, hi = store.rec_offsets[r], store.rec_offsets[r + 1]
        want = lo + np.searchsorted(store.start[lo:hi], vs, side="left")
        assert got[r] == want.tolist(), r
    assert loaded.file_columns()[1] == (["rec_id", "end", "order"] if route == "host"
                                        else list(COLUMNS))


def _end_before_start(store):
    end = store.end.copy()
    i = int(store.rec_offsets[0]) + 17
    end[i] = store.start[i] - 1
    return RefStore(record_names=store.record_names, record_lens=store.record_lens,
                    n_docs=store.n_docs, kind=store.kind, rec_id=store.rec_id,
                    start=store.start, end=end, order=store.order)


@pytest.mark.parametrize("writer", WRITERS)
def test_end_before_start_raises_memo_tpus_error(stores, tmp_path, writer):
    """One row of a loaded store with end < start: the set-up raises the
    ValueError memo_tpu's raises, with its text."""
    bad = _end_before_start(stores["records"])
    with pytest.raises(ValueError) as theirs:
        JaxResident(bad, make_mesh(dp=1, sp=1, devices=jax.devices()[:1]), k_max=K_MAX,
                    records=list(LENS))
    path = tmp_path / "idx.npz"
    _save(bad, writer, path)
    with pytest.raises(ValueError) as mine:
        ResidentShardedQuery(IntervalStore.load(path), "cpu", k_max=K_MAX, records=list(LENS))
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("column", ["start", "end"])
@pytest.mark.parametrize("writer", ["port_deflated", "port_stored"])
def test_a_corrupt_member_raises(stores, tmp_path, monkeypatch, writer, column):
    """A flipped bit in a column's data (read whole: every record placed)
    raises the exception ``np.load``'s read of the member raises."""
    monkeypatch.setattr(npz_mod, "CHUNK_BYTES", 4096)
    path = tmp_path / "idx.npz"
    _save(stores["records"], writer, path)
    member = npz_mod.NpzMembers(path).member(column)
    data = bytearray(path.read_bytes())
    data[member.offset + member.compressed_size // 2] ^= 8
    path.write_bytes(bytes(data))
    with pytest.raises(Exception) as want:
        with np.load(path) as z:
            z[column]
    with pytest.raises(want.type):
        ResidentShardedQuery(IntervalStore.load(path), "cpu", k_max=K_MAX, records=list(LENS))


@pytest.mark.parametrize("mode", MODES)
def test_windows_come_back_in_one_copy_and_one_wait(stores, monkeypatch, mode):
    """With host output, a ``*_windows`` call makes one copy to the host
    (``engine._copy_back``) and one wait, whatever the number of windows;
    the outputs are the numpy engine's, and a caller's writes to them reach
    neither the memoized output nor another window."""
    calls = []

    class Ready:
        def synchronize(self):
            calls.append("wait")

    def copy_back(t):
        calls.append(("copy", tuple(t.shape)))
        return t.clone(), Ready()

    monkeypatch.setattr(engine_mod, "_copy_back", copy_back)
    store = stores["records"]
    rq = ResidentShardedQuery(store, "cpu", k_max=K_MAX, records=list(LENS))
    oracle = JaxEngine(store, backend="numpy")
    for k in (1, 31):
        for name, wins in WINDOWS.items():
            calls.clear()
            got = getattr(rq, f"{mode}_windows")(wins, k, record=name)
            rows = sum(qe - qs for qs, qe in wins)
            assert [c if c == "wait" else c[0] for c in calls] == ["copy", "wait"]
            assert calls[0][1][0] == rows
            for (qs, qe), g in zip(wins, got):
                np.testing.assert_array_equal(g, getattr(oracle, mode)(name, qs, qe, k))
            got[0][...] = 7
            again = getattr(rq, f"{mode}_windows")(wins, k, record=name)
            np.testing.assert_array_equal(again[0], getattr(oracle, mode)(name, *wins[0], k))
            np.testing.assert_array_equal(got[1], again[1])
    calls.clear()
    assert getattr(rq, f"{mode}_windows")([], 31, record="r0") == [] and calls == []


def test_stratified_set_up_drops_the_streamed_rows(tmp_path, monkeypatch):
    """Over 2^20 rows, most of them long: the engine places its rows in
    length buckets, and by then nothing holds the rows that the set-up
    streamed, so that the buckets are built with those freed (the device
    peak of the set-up is the engine's own)."""
    import weakref

    rng = np.random.default_rng(5)
    n = (1 << 20) + 4096
    start = np.sort(rng.integers(0, 1 << 21, n))
    store = IntervalStore(record_names=["r0"], record_lens=[1 << 21], n_docs=5,
                          kind="conservation", rec_id=np.zeros(n, np.int32), start=start,
                          end=start + rng.integers(0, 1000, n), order=rng.integers(1, 5, n))
    path = tmp_path / "idx.npz"
    store.save(path, compressed=False)
    refs, alive = [], []
    rows, init = ResidentShardedQuery._rows, engine_mod.QueryEngine._init_stratified

    def kept_rows(self, *args):
        cols = rows(self, *args)
        refs.extend(weakref.ref(c) for c in cols)
        return cols

    def checked_init(self, buckets):
        alive.append(sum(r() is not None for r in refs))
        return init(self, buckets)

    monkeypatch.setattr(ResidentShardedQuery, "_rows", kept_rows)
    monkeypatch.setattr(engine_mod.QueryEngine, "_init_stratified", checked_init)
    rq = ResidentShardedQuery(IntervalStore.load(path), "cpu", k_max=1024)
    assert rq.engine._children is not None and len(refs) == 4 and alive == [0]
    assert rq.local_rows == n
