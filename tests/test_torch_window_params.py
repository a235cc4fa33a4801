"""The fused kernels' window parameters found on the device
(``memo_tpu_torch.query.window``), on CPU tensors, held exactly to memo_tpu's
``QueryEngine._window_params`` (its host searches and
``QueryLayout.prefix_counts``) and to the port's numpy plain version; the
engine that searches there against memo_tpu's numpy engine, one window and
batches, whole and in length buckets, for the ``fused`` and ``torch``
backends; and the engine and its buckets keep no host copy of their rows
and read back only the candidate counts. The cases are
``tests/window_cases.py``'s; ``test_torch_window_params_card.py`` holds the
card's parameters to the CPU's. Tolerance: exact (integers)."""

import dataclasses

import numpy as np
import pytest
import torch

from memo_tpu.index.builder import store_from_ms
from memo_tpu.index.store import IntervalStore as RefStore
from memo_tpu.query.engine import QueryEngine as JaxEngine
from memo_tpu_torch import QueryEngine
from memo_tpu_torch.index import store as store_mod
from memo_tpu_torch.index.placement import place_store_and_layout
from memo_tpu_torch.index.store import IntervalStore, QueryLayout
from memo_tpu_torch.parallel import ResidentShardedQuery
from memo_tpu_torch.query import window
from memo_tpu_torch.query.window import window_params, window_params_numpy
from memo_stats import memo_tpu_stats
from window_cases import CASES, HUGE_K, REC_LEN, WINDOWS, case_arrays, lipschitz

@pytest.fixture(scope="module", params=CASES)
def case(request):
    arrays = case_arrays(request.param)
    store, ref = IntervalStore(kind="conservation", **arrays), RefStore(kind="conservation", **arrays)
    placed, lay = place_store_and_layout(store, "cpu", 8)
    jeng = JaxEngine(ref, backend="pallas", stratify=False)
    return request.param, store, ref, placed, lay, jeng


@pytest.mark.parametrize("k", [1, 2, 31, 3 * REC_LEN, HUGE_K])
def test_device_params_equal_memo_tpus(case, k):
    """Every window of every record, in batches of one length: params, the
    prefix and the counts equal memo_tpu's ``_window_params`` and the
    port's numpy plain version; dtypes and shapes are the kernels'."""
    name, store, ref, placed, lay, jeng = case
    C = store.n_docs
    numpy_layout = QueryLayout.build(store)
    assert lay.monotone == name.startswith("ms_") or name == "empty_store"
    if k == 3 * REC_LEN and lay.monotone and store.num_intervals:
        assert k > lay.key_stride  # E0 clamps to the stride
    for r, record in enumerate(store.record_names):
        for L, starts in WINDOWS:
            got = window_params(placed, lay, r, starts, L, k)
            assert got.params.dtype == got.prefix.dtype == got.counts.dtype == torch.int32
            assert got.params.shape == (len(starts), 5) and got.params.is_contiguous()
            assert got.prefix.shape == (len(starts), C) and got.prefix.is_contiguous()
            want = [jeng._window_params(record, qs, qs + L, k) for qs in starts]
            ranges = np.array([w[:4] + (qs,) for w, qs in zip(want, starts)], np.int64)
            prefix = np.stack([w[4] for w in want])
            where = f"{name} {record} L={L} k={k}"
            np.testing.assert_array_equal(got.params.numpy(), ranges, err_msg=where)
            np.testing.assert_array_equal(got.prefix.numpy(), prefix, err_msg=where)
            np.testing.assert_array_equal(got.counts.numpy(),
                                          np.stack([ranges[:, 1] - ranges[:, 0],
                                                    ranges[:, 3] - ranges[:, 2]]), err_msg=where)
            plain = window_params_numpy(store, numpy_layout, r, starts, L, k)
            np.testing.assert_array_equal(plain[0], ranges, err_msg=where)
            np.testing.assert_array_equal(plain[1], prefix, err_msg=where)


def test_cpu_runs_the_plain_version_and_counts_no_launch(case):
    """On CPU tensors ``window_params`` is its plain version and launches
    nothing."""
    _, store, _, placed, lay, _ = case
    before = window.window_params.launches
    for r in range(store.num_records):
        got = window_params(placed, lay, r, [0, 5, 300], 20, 3)
        want = window.window_params_reference(placed, lay, r, [0, 5, 300], 20, 3)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert window.window_params.launches == before


def test_refuses_tensors_off_cpu_and_cuda(case):
    """A store that is neither on the CPU nor on a CUDA device never falls
    back to the plain version."""
    _, _, _, placed, lay, _ = case
    meta = type(placed)(*(torch.zeros(t.shape, dtype=t.dtype, device="meta") for t in placed))
    with pytest.raises(ValueError, match="CUDA"):
        window_params(meta, lay, 0, [0], 10, 3)


@pytest.mark.parametrize("pairs", [1, 50, 1 << 24], ids=["one_pair", "groups", "one_step"])
def test_scan_fallback_in_steps_equals_memo_tpu(monkeypatch, pairs):
    """The scan fallback (orders outside [0, C)) split into steps of a few
    windows gives the prefix of one step."""
    arrays = case_arrays("orders_out_of_range")
    store, ref = IntervalStore(kind="conservation", **arrays), RefStore(kind="conservation", **arrays)
    placed, lay = place_store_and_layout(store, "cpu", 8)
    jeng = JaxEngine(ref, backend="pallas", stratify=False)
    monkeypatch.setattr(window, "SCAN_PAIRS", pairs)
    starts = list(range(0, REC_LEN, 23))
    for k in (1, 31):
        got = window_params(placed, lay, 0, starts, 40, k).prefix.numpy()
        want = np.stack([jeng._window_params("chr0", qs, qs + 40, k)[4] for qs in starts])
        np.testing.assert_array_equal(got, want)


def test_window_bounds_equal_the_stores(case):
    """The torch backend's candidate rows: ``IntervalStore.window_bounds``,
    found over the placed rows."""
    _, store, ref, placed, lay, _ = case
    for r, record in enumerate(store.record_names):
        for qs, qe, k in ((0, 1, 1), (0, REC_LEN, 31), (REC_LEN - 3, REC_LEN + 9, 5),
                          (123, 300, HUGE_K)):
            assert window.window_bounds(placed, lay, r, qs, qe, k) == \
                ref.window_bounds(record, qs, qe, k)


@pytest.fixture(scope="module")
def mixed_store():
    """Half short and half long intervals over two records: splits into at
    least 3 length buckets."""
    rng = np.random.default_rng(13)
    mix = np.where(rng.random((900, 8)) < 0.5, rng.integers(0, 40, (900, 8)),
                   rng.integers(100, 3000, (900, 8))).astype(np.int32)
    return store_from_ms([lipschitz(mix), lipschitz(mix[:400])], ["chrA", "chrB"], [900, 400],
                         9, "conservation")


def _copy(store, **fields) -> IntervalStore:
    """The port's IntervalStore of ``store``'s fields, some replaced."""
    return IntervalStore(**{f.name: getattr(store, f.name) for f in dataclasses.fields(store)}
                         | fields)


BATCH = ((0, 300), (250, 900), (899, 900), (600, 600), (10, 11))


@pytest.mark.parametrize("kind", ["conservation", "membership"])
@pytest.mark.parametrize("stratify", [True, False], ids=["stratified", "whole"])
@pytest.mark.parametrize("backend", ["fused", "torch"])
def test_engine_batches_equal_numpy_engine(mixed_store, backend, stratify, kind):
    """Batches of windows (one launch per bucket on ``fused``) and single
    windows equal memo_tpu's numpy engine, at k where one, several or no
    bucket marks."""
    store = _copy(mixed_store, kind=kind)
    eng = QueryEngine(store, backend=backend, stratify=stratify, device="cpu")
    assert (eng._children is not None) == stratify
    oracle = JaxEngine(store, backend="numpy")
    for k in (2, 31, 200, 5000):
        outs = getattr(eng, f"{kind}_batch")("chrA", BATCH, k)
        for (qs, qe), got in zip(BATCH, outs):
            want = getattr(oracle, kind)("chrA", qs, qe, k)
            np.testing.assert_array_equal(np.asarray(got), want, err_msg=f"{qs}-{qe} k={k}")
            np.testing.assert_array_equal(getattr(eng, kind)("chrA", qs, qe, k), want)


class _Refused:
    """Stands for a host row array the engine must not read."""

    def __getattr__(self, name):
        raise AssertionError("a query read the host store's rows")

    def __getitem__(self, key):
        raise AssertionError("a query read the host store's rows")

    def __array__(self, *args, **kwargs):
        raise AssertionError("a query read the host store's rows")

    def __len__(self):
        raise AssertionError("a query read the host store's rows")


def _host_arrays(obj, skip, seen=None, path="engine"):
    """(path, numpy array) of every array reachable from ``obj``'s
    attributes, containers and children, not through ``skip``."""
    seen = set() if seen is None else seen
    if id(obj) in seen or obj is skip or isinstance(obj, (torch.Tensor, str, int, float)):
        return
    seen.add(id(obj))
    if isinstance(obj, np.ndarray):
        yield path, obj
    elif isinstance(obj, dict):
        for key, value in obj.items():
            yield from _host_arrays(value, skip, seen, f"{path}[{key!r}]")
    elif isinstance(obj, (list, tuple)):
        for i, value in enumerate(obj):
            yield from _host_arrays(value, skip, seen, f"{path}[{i}]")
    elif hasattr(obj, "__dict__"):
        for key, value in vars(obj).items():
            yield from _host_arrays(value, skip, seen, f"{path}.{key}")


@pytest.mark.parametrize("owner", ["fused-whole", "fused-stratified", "torch-stratified",
                                   "resident"])
def test_engine_keeps_no_host_rows_and_reads_back_only_counts(mixed_store, owner, monkeypatch):
    """Set-up and queries never call the numpy layout, its prefix counts or
    the host window search; no array the engine, its buckets or its layouts
    hold has more than R + 1 elements (the store is the caller's, shared);
    after set-up the host store's rows can go, and the outputs still equal
    the numpy engine's; and a fused query reads back nothing, at the
    default cap and at a cap of 64 that chunks pass (launching as many
    kernels at either), while its ``last_stats``, read after it, reads
    only candidate counts, int32 [2, Q] tensors (``torch``: the two bounds
    of each chunk)."""
    def refuse(*args, **kwargs):
        raise AssertionError("the engine searched the host")

    store = _copy(mixed_store)
    oracle = JaxEngine(mixed_store, backend="numpy")
    windows = [(0, 300), (250, 900), (899, 900)]
    want = {k: [oracle.conservation("chrA", qs, qe, k) for qs, qe in windows] for k in (2, 31, 200)}
    for target, name in ((store_mod.QueryLayout, "build"), (store_mod.QueryLayout, "prefix_counts"),
                         (IntervalStore, "window_bounds")):
        if owner != "resident" or name != "window_bounds":  # resident cuts its slabs on the host
            monkeypatch.setattr(target, name, refuse)
    if owner == "resident":
        holder = ResidentShardedQuery(store, "cpu", k_max=1024, device_output=True)
        eng = holder.engine
    else:
        backend, split = owner.split("-")
        eng = holder = QueryEngine(store, backend=backend, stratify=split == "stratified",
                                   device="cpu", device_output=True)
    assert eng.store is store and all(c.store is store for _, c in eng._children or [])
    R = store.num_records
    big = [(path, a.size) for path, a in _host_arrays(holder, skip=store) if a.size > R + 1]
    assert not big, big
    monkeypatch.setattr(IntervalStore, "window_bounds", refuse)
    for name in ("rec_id", "start", "end", "order", "rec_offsets", "max_interval_len"):
        setattr(store, name, _Refused())

    reads, log, recording = [], [], [False]
    for method in ("tolist", "item", "numpy", "__int__", "__index__", "__bool__"):
        def record(self, *args, _real=getattr(torch.Tensor, method), _method=method, **kwargs):
            out = _real(self, *args, **kwargs)
            if recording[0]:
                reads.append((_method, self.dtype, tuple(self.shape)))
                log.append(("read", out))
            return out

        monkeypatch.setattr(torch.Tensor, method, record)
    from memo_tpu_torch.query import engine as engine_mod

    real_kernel, launches = engine_mod.fused_query_rows, []

    def kernel(*args, **kwargs):  # its plain version reads the parameters on the CPU: not counted
        recording[0] = False
        launches.append(1)
        log.append(("launch",))
        try:
            return real_kernel(*args, **kwargs)
        finally:
            recording[0] = True

    monkeypatch.setattr(engine_mod, "fused_query_rows", kernel)

    stats_reads = []

    def queries():
        for k, outs in want.items():
            recording[0] = True
            if owner == "resident":
                got = holder.conservation_windows(windows, k, record="chrA")
            elif k == 31:
                got = eng.conservation_batch("chrA", windows, k)
            else:
                got = [eng.conservation("chrA", qs, qe, k) for qs, qe in windows]
            recording[0] = False
            for g, w in zip(got, outs):
                np.testing.assert_array_equal(g.numpy(), w)
            n_reads = len(reads)
            recording[0] = True
            eng.last_stats.as_dict()
            recording[0] = False
            stats_reads.extend(reads[n_reads:])
            del reads[n_reads:]

    queries()
    if owner.startswith("torch"):
        assert reads and all(r == ("tolist", torch.int64, (2,)) for r in reads), reads
        return
    assert launches and not reads, (reads, launches)
    count_reads = [r for r in stats_reads if r[0] == "tolist" and r[1] == torch.int32
                   and len(r[2]) == 2 and r[2][0] == 2]
    assert count_reads and count_reads == stats_reads, stats_reads

    # A cap of 64, below chrA's rows in every engine that has some, which
    # chunks pass: with the card's count copy stood in for, the queries make
    # as many launches and read and wait on nothing; their stats, read
    # after each, read only candidate counts (more of them: the halving's).
    class Copied:
        def synchronize(self):
            log.append(("wait",))

    monkeypatch.setattr(engine_mod, "_copy_back", lambda t: (t, Copied()))
    for engine in (eng, *(child for _, child in eng._children or [])):
        engine.max_intervals = 64
    if owner == "resident":
        holder._full_cache.clear()
    n_launches, n_count_reads = len(launches), len(stats_reads)
    for held in (reads, log, launches, stats_reads):
        held.clear()
    queries()
    assert not reads and ("wait",) not in log and len(launches) == n_launches, (reads, log)
    assert all(r[0] == "tolist" and r[1] == torch.int32 and len(r[2]) == 2 and r[2][0] == 2
               for r in stats_reads) and len(stats_reads) > n_count_reads, stats_reads


@pytest.mark.parametrize("cap", ["provable", "small"])
@pytest.mark.parametrize("counts_on", ["host", "card"])
@pytest.mark.parametrize("kind", ["conservation", "membership"])
@pytest.mark.parametrize("stratify", [True, False], ids=["stratified", "whole"])
def test_chunked_query_reads_counts_once(mixed_store, stratify, kind, counts_on, cap, monkeypatch):
    """A query over seven full position chunks and a shorter last one finds
    every chunk's parameters first, then launches one kernel a chunk in
    every live bucket, and reads no count and waits on nothing, at the
    default cap ("provable": every live bucket's rows of the record within
    it) and at a cap of 64 that chunks pass ("small"), where the counts are
    on the host at once (the CPU) and where they would come back from the
    card ("card": the copy's event stood in for). The output equals
    memo_tpu's numpy engine; ``last_stats``, read after it, reads int32
    [2, n] counts and equals memo_tpu's at the same cap."""
    from memo_tpu_torch.query import engine as engine_mod

    store = _copy(mixed_store, kind=kind)
    eng = QueryEngine(store, backend="fused", chunk_positions=128, stratify=stratify,
                      device="cpu", device_output=True)
    oracle = JaxEngine(store, backend="numpy")
    engines = [child for _, child in eng._children] if stratify else [eng]
    if cap == "small":
        for engine in (eng, *engines):
            engine.max_intervals = 64
        worst = max(int(engines[0]._window_params("chrA", [qs], 128, k).counts.max())
                    for qs in range(0, 900, 128) for k in (31, 200))
        assert worst > 64, worst  # chunks over the cap, launched whole
    events, recording = [], [False]

    class Copied:
        def synchronize(self):
            events.append(("wait",))

    if counts_on == "card":
        monkeypatch.setattr(engine_mod, "_copy_back", lambda t: (t, Copied()))

    def tolist(self, _real=torch.Tensor.tolist):
        if recording[0]:
            events.append(("read", self.dtype, tuple(self.shape)))
        return _real(self)

    real_kernel = engine_mod.fused_query_rows

    def kernel(*args, **kwargs):
        events.append(("launch",))
        recording[0] = False  # the plain version's own reads are not the engine's
        try:
            return real_kernel(*args, **kwargs)
        finally:
            recording[0] = True

    monkeypatch.setattr(torch.Tensor, "tolist", tolist)
    monkeypatch.setattr(engine_mod, "fused_query_rows", kernel)
    for k in (31, 200):
        events.clear()
        recording[0] = True
        got = getattr(eng, kind)("chrA", 0, 900, k)
        recording[0] = False
        np.testing.assert_array_equal(got.numpy(), getattr(oracle, kind)("chrA", 0, 900, k))
        live = [e for lb, e in eng._children or [(0, eng)] if lb < k - 1]
        assert events == [("launch",)] * (8 * len(live)), events
        events.clear()
        recording[0] = True
        stats = eng.last_stats.as_dict()
        recording[0] = False
        assert events and all(e[:2] == ("read", torch.int32) and e[2][0] == 2 for e in events)
        assert stats == memo_tpu_stats(store, "chrA", k, chunk_positions=128, stratify=stratify,
                                       cap=engines[0].max_intervals, region=(0, 900),
                                       membership=kind == "membership")
