"""The fused engine takes every window whole, on the CPU with the card's
count copy stood in for (``test_torch_query_sync.py``'s log of steps,
launches, waits and host reads).

- At caps of 16 and 64 candidates and at the default, k = 3, 31 and 51,
  conservation and membership, through the single-window, chunked,
  stratified, batch (whole and stratified) and resident paths: the query
  reads and waits on nothing, each chunk or batch is launched once, the
  outputs equal memo_tpu's numpy engine, and ``last_stats``, read after
  it, reads the counts then (and finds the halves' counts where memo_tpu
  halves) and equals memo_tpu's fused engine's stats at the same cap
  (``memo_stats.py``).
- The placed tensors hold the rows and ``ROW_SLACK + 1`` sentinel rows, and
  the ``torch`` backend and both kernels' plain versions stay exact where
  a window's candidate range ends at the last placed row and where a
  batch's widest range, read from a window near the end, reaches past the
  placed rows.

Tolerance: exact (integers)."""

import dataclasses

import numpy as np
import pytest
from memo_stats import memo_tpu_stats
from test_torch_query_sync import (  # noqa: F401 (fixtures)
    PATHS,
    REC_LEN,
    WINDOWS,
    _engines,
    _make,
    _query,
    _set_cap,
    _store,
    _want,
    logged,
    mixed,
)

from memo_tpu.query.engine import QueryEngine as JaxEngine
from memo_tpu_torch import QueryEngine
from memo_tpu_torch.index.builder import store_from_ms
from memo_tpu_torch.index.store import IntervalStore
from memo_tpu_torch.ops.fused_query_v2 import ROW_SLACK
from memo_tpu_torch.parallel import ResidentShardedQuery
from memo_tpu_torch.query.engine import _next_pow2
from window_cases import lipschitz

KS = (3, 31, 51)
CAPS = (16, 64, None)  # None: the default cap


def _resident_rows(store, k_max: int = 1024) -> IntervalStore:
    """The rows resident's engine holds for chrA on one device: the
    record's rows shorter than k_max - 1."""
    lengths = store.end - store.start
    keep = (store.rec_id == store.record_index("chrA")) & (lengths < k_max - 1)
    fields = {f.name: getattr(store, f.name) for f in dataclasses.fields(store)}
    return IntervalStore(**fields | {name: fields[name][keep]
                                     for name in ("rec_id", "start", "end", "order")})


def _memo_tpu_stats(path: str, store, k: int, cap, membership: bool) -> dict:
    """memo_tpu's stats of :func:`_query`'s query through ``path``."""
    if path == "resident":  # one window of the whole record over resident's rows
        return memo_tpu_stats(_resident_rows(store), "chrA", k, cap=cap,
                              windows=[(0, REC_LEN)], membership=membership)
    window = {"windows": WINDOWS} if path.startswith("batch") else {"region": (0, REC_LEN)}
    chunk = 128 if path in ("chunked", "stratified") else None
    return memo_tpu_stats(store, "chrA", k, cap=cap, chunk_positions=chunk,
                          stratify=path.endswith("stratified"), membership=membership, **window)


@pytest.mark.parametrize("cap", CAPS, ids=["cap16", "cap64", "default"])
@pytest.mark.parametrize("kind", ["conservation", "membership"])
@pytest.mark.parametrize("path", PATHS)
def test_whole_windows_equal_memo_tpu(mixed, logged, path, kind, cap):  # noqa: F811
    store = _store(mixed, kind)
    holder, oracle = _make(path, store), JaxEngine(store, backend="numpy")
    uncapped = _make(path, store)
    if cap is not None:
        _set_cap(holder, cap)
    engine = holder.engine if path == "resident" else holder
    halved = False
    for k in KS:
        got, events = logged(lambda: _query(path, holder, kind, k))
        _, want_events = logged(lambda: _query(path, uncapped, kind, k))
        assert "read" not in events and "wait" not in events, events
        assert events == want_events, (events, want_events)  # launched once, whole
        for g, w in zip(got, _want(path, oracle, kind, k)):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{path} k={k}")
        stats, read = logged(lambda: engine.last_stats.as_dict())
        assert "launch" not in read and "wait" not in read, read
        assert ("read" in read) == ("launch" in events), read
        halved |= "step" in read
        want = _memo_tpu_stats(path, store, k, cap, kind == "membership")
        assert stats == want, (k, stats, want)
    if cap == 16:  # halves some chunk on every path
        assert halved
    elif cap is None:  # halves none
        assert not halved


@pytest.fixture(scope="module")
def tail_store():
    """One record whose last positions are covered by many short rows: a
    window at its end has a candidate range that ends at the last row."""
    rng = np.random.default_rng(29)
    ms = lipschitz(rng.integers(0, 12, (300, 7)).astype(np.int32))
    return store_from_ms([ms], ["chr0"], [300], 8, "conservation")


def _kind(store, kind: str) -> IntervalStore:
    return IntervalStore(**{f.name: getattr(store, f.name) for f in dataclasses.fields(store)}
                         | {"kind": kind})


@pytest.mark.parametrize("stratify", [False, True], ids=["whole", "stratified"])
def test_placed_rows_hold_row_slack_plus_one_pad(mixed, stratify):  # noqa: F811
    """Each placed tensor of each engine (and of resident's) holds its rows
    and ``ROW_SLACK + 1`` sentinel rows (start 0, end 0, order -1)."""
    store = _store(mixed, "conservation")
    holders = [QueryEngine(store, device="cpu", stratify=stratify),
               ResidentShardedQuery(store, "cpu", record="chrA", k_max=1024)]
    for holder in holders:
        for eng in _engines(holder):
            n = eng._layout.num_rows
            for t, fill in zip(eng._d, (0, 0, -1, 0, 0, -1)):
                assert t.shape == (n + ROW_SLACK + 1,) and (t[n:] == fill).all()


@pytest.mark.parametrize("kind", ["conservation", "membership"])
@pytest.mark.parametrize("backend", ["v1", "v2", "torch"])
def test_ranges_at_the_last_row_stay_exact(tail_store, backend, kind):
    """Windows at the record's end, whose candidate ranges end at the last
    placed row, one at a time and in a batch with a window over the whole
    record, so that the batch's widest range, read from a window near the
    end, passes the placed rows (the plain versions read M rows from each
    window's first); the ``torch`` backend's pow2 slice passes them too.
    Outputs equal memo_tpu's numpy engine."""
    store = _kind(tail_store, kind)
    options = ({"backend": "torch"} if backend == "torch"
               else {"backend": "fused", "kernel_version": backend})
    eng = QueryEngine(store, device="cpu", stratify=False, **options)
    oracle = JaxEngine(store, backend="numpy")
    n_placed = eng._d.start.numel()
    ends = [(qs, 300) for qs in range(270, 300, 3)]
    passed = False
    for k in (2, 5, 9):
        for qs, qe in ends:
            np.testing.assert_array_equal(getattr(eng, kind)("chr0", qs, qe, k),
                                          getattr(oracle, kind)("chr0", qs, qe, k))
            lo, hi = eng._window_bounds("chr0", qs, qe, k)
            passed |= backend == "torch" and lo + _next_pow2(hi - lo) > n_placed
        batch = [(0, 300)] + ends
        for (qs, qe), got in zip(batch, getattr(eng, f"{kind}_batch")("chr0", batch, k)):
            np.testing.assert_array_equal(got, getattr(oracle, kind)("chr0", qs, qe, k))
        wp = eng._window_params("chr0", [qs for qs, _ in batch], 300, k)
        mlo, mhi, plo, phi, _ = wp.params.T.tolist()
        widest = max(max(b - a for a, b in zip(mlo, mhi)), max(b - a for a, b in zip(plo, phi)))
        assert max(mhi) == max(phi) == eng._layout.num_rows  # ranges end at the last row
        passed |= backend != "torch" and max(mlo[1:] + plo[1:]) + widest > n_placed
    assert passed
