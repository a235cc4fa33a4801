"""The store's placement and query layout built with torch ops
(``memo_tpu_torch.index.placement``), on CPU tensors, held array for array
to memo_tpu's ``QueryLayout.build`` and the port's numpy copy of it (the
device layout read back in the test only), its prefix to their
``prefix_counts``; the
engine that places through it against memo_tpu's numpy oracle; the engine's
positional parameters against memo_tpu's; and the ``entry()`` twin against
memo_tpu's ``__graft_entry__.entry()`` under ``jax.jit``."""

import inspect

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
from memo_tpu.index.builder import store_from_ms
from memo_tpu.index.store import IntervalStore as RefStore
from memo_tpu.index.store import QueryLayout as RefLayout
from memo_tpu.query.engine import QueryEngine as JaxEngine
from memo_tpu_torch import QueryEngine
from memo_tpu_torch.entry import entry
from memo_tpu_torch.index import store as store_mod
from memo_tpu_torch.index.placement import (
    place_columns,
    place_store_and_layout,
    short_share,
    split_by_length,
    upload_columns,
)
from memo_tpu_torch.index.store import IntervalStore, QueryLayout
from memo_tpu_torch.query.window import window_params

C = 6
REC_LEN = 300


def _lipschitz(ms: np.ndarray) -> np.ndarray:
    """Matching statistics drop by at most 1 a position: min_{q>=p}(ms[q]+q) - p."""
    idx = np.arange(ms.shape[0], dtype=np.int64)[:, None]
    return (np.minimum.accumulate((ms + idx)[::-1])[::-1] - idx).astype(np.int32)


def _random_rows(rng, recs, n, span_hi, start_lo=0, start_hi=REC_LEN, order_lo=0, order_hi=C):
    rec = rng.choice(np.asarray(recs), n)
    start = rng.integers(start_lo, start_hi, n)
    end = start + rng.integers(0, span_hi, n)
    order = rng.integers(order_lo, order_hi, n)
    return rec, start, end, order


def _arrays(case: str) -> dict:
    """The store arrays of one layout corner case."""
    rng = np.random.default_rng(sum(map(ord, case)))
    names, lens = ["chr0", "chr1", "chr2"], [REC_LEN] * 3
    if case in ("one_record", "several_records"):
        n_rec = 1 if case == "one_record" else 3
        ms = [_lipschitz(rng.integers(0, 40, (REC_LEN, C - 1))) for _ in range(n_rec)]
        st = store_from_ms(ms, names[:n_rec], lens[:n_rec], C, "conservation")
        return {"record_names": names[:n_rec], "record_lens": lens[:n_rec], "rec_id": st.rec_id,
                "start": st.start, "end": st.end, "order": st.order}
    if case == "empty_store":
        rows = (np.zeros(0, np.int64),) * 4
    elif case == "empty_record":  # chr1 holds no row
        rows = _random_rows(rng, [0, 2], 400, 30)
    elif case == "ties":  # many rows share a start, an end or both
        rows = _random_rows(rng, [0, 1], 500, 3, start_hi=12)
    elif case == "non_monotone":
        rows = _random_rows(rng, [0, 1, 2], 600, 200)
    elif case == "orders_out_of_range":  # the scan path
        rows = _random_rows(rng, [0, 1], 400, 40, order_lo=-1, order_hi=C + 2)
    elif case == "ends_2x":  # ends up to twice a record's length
        rows = _random_rows(rng, [0, 1, 2], 400, 2 * REC_LEN, start_hi=REC_LEN)
        rows[2][:3] = 2 * REC_LEN
    elif case == "unsorted_rows":  # not in (record, start) order
        rows = _random_rows(rng, [0, 1, 2], 400, 40)
    elif case == "negative_coordinates":
        rows = _random_rows(rng, [0, 1], 300, 40, start_lo=-60)
    else:
        raise ValueError(case)
    rec, start, end, order = rows
    if case not in ("unsorted_rows", "empty_store"):
        keep = np.lexsort((end, start, rec))
        rec, start, end, order = rec[keep], start[keep], end[keep], order[keep]
    return {"record_names": names, "record_lens": lens, "rec_id": rec, "start": start,
            "end": end, "order": order}


CASES = ["one_record", "several_records", "empty_record", "empty_store", "ties", "non_monotone",
         "orders_out_of_range", "ends_2x", "unsorted_rows", "negative_coordinates"]


def _stores(case: str):
    arrays = _arrays(case)
    common = dict(n_docs=C, kind="conservation", **arrays)
    return IntervalStore(**common), RefStore(**common)


def _old_place_store(store, pad: int) -> list[torch.Tensor]:
    """The placement before the layout moved to the device: the numpy
    QueryLayout's rows cast to int32, each followed by ``pad`` sentinel rows."""
    lay = QueryLayout.build(store)
    out = []
    for a, fill in ((store.start, 0), (store.end, 0), (store.order, -1), (lay.end_sorted, 0),
                    (lay.start_by_end, 0), (lay.order_by_end, -1)):
        t = torch.full((a.shape[0] + pad,), fill, dtype=torch.int32)
        t[: a.shape[0]] = torch.from_numpy(a.astype(np.int32))
        out.append(t)
    return out


@pytest.mark.parametrize("reference", ["memo_tpu", "port_numpy"])
@pytest.mark.parametrize("case", CASES)
def test_layout_equals_numpy_build(case, reference):
    store, ref_store = _stores(case)
    want = RefLayout.build(ref_store) if reference == "memo_tpu" else QueryLayout.build(store)
    pad = 5
    placed, lay = place_store_and_layout(store, "cpu", pad)
    n = store.num_intervals
    for name in ("col_offsets", "s_keys", "e_keys"):
        got, exp = getattr(lay, name).numpy(), getattr(want, name)
        assert got.dtype == exp.dtype, name
        np.testing.assert_array_equal(got, exp, err_msg=name)
    assert (lay.monotone, lay.key_stride) == (want.monotone, want.key_stride)
    assert lay.monotone == (case in ("one_record", "several_records", "empty_store"))
    # The by-column gathers, read back out of the composite keys.
    seg = np.repeat(np.arange(len(want.col_offsets) - 1), np.diff(want.col_offsets))
    np.testing.assert_array_equal(lay.s_keys.numpy() - seg * lay.key_stride, want.s_by_col)
    np.testing.assert_array_equal(lay.e_keys.numpy() - seg * lay.key_stride, want.e_by_col)
    rows = (store.start, store.end, store.order, want.end_sorted, want.start_by_end,
            want.order_by_end)
    for t, exp, fill in zip(placed, rows, (0, 0, -1, 0, 0, -1)):
        assert t.dtype == torch.int32 and t.shape == (n + pad,)
        np.testing.assert_array_equal(t[:n].numpy(), exp.astype(np.int32))
        assert (t[n:] == fill).all()
    # IntervalStore's own record offsets and longest intervals, R-sized on the host.
    assert lay.num_rows == n
    for got, exp in ((lay.rec_offsets, ref_store.rec_offsets),
                     (lay.longest, ref_store.max_interval_len)):
        assert isinstance(got, np.ndarray) and got.dtype == exp.dtype
        np.testing.assert_array_equal(got, exp)
    for r in range(store.num_records):
        for qs, k in ((0, 1), (37, 3), (150, 31), (REC_LEN - 1, 101)):
            got = window_params(placed, lay, r, [qs], 1, k).prefix[0]
            np.testing.assert_array_equal(got.numpy(), want.prefix_counts(ref_store, r, qs, k))


@pytest.mark.parametrize("pad", [1, 64])
@pytest.mark.parametrize("case", CASES)
def test_placed_store_equals_old_placement(case, pad):
    store, _ = _stores(case)
    placed, _ = place_store_and_layout(store, "cpu", pad)
    for got, want in zip(placed, _old_place_store(store, pad)):
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("edges", [(32, 128, 512, 2048), (3, 10, 50)], ids=["strata", "narrow"])
@pytest.mark.parametrize("case", CASES)
def test_length_buckets_equal_memo_tpus_split(case, edges):
    """Each nonempty bucket of ``split_by_length`` holds the rows of the
    sub-store memo_tpu's ``_init_stratified`` builds on the host (by
    ``np.searchsorted`` of the lengths), array for array and in dtype, and
    its placement's layout the sub-store's record offsets and longest
    intervals (``IntervalStore``'s)."""
    store, ref_store = _stores(case)
    b_id = np.searchsorted(np.asarray(edges, np.int64), ref_store.end - ref_store.start,
                           side="right")
    want = []
    for b in range(len(edges) + 1):
        rows = np.flatnonzero(b_id == b)
        if rows.size:
            want.append((b, RefStore(
                record_names=ref_store.record_names, record_lens=ref_store.record_lens,
                n_docs=C, kind="conservation", rec_id=ref_store.rec_id[rows],
                start=ref_store.start[rows], end=ref_store.end[rows], order=ref_store.order[rows])))
    got = split_by_length(upload_columns(store, "cpu"), edges)
    assert [b for b, _ in got] == [b for b, _ in want]
    for (_, cols), (_, exp) in zip(got, want):
        for name, col in zip(("rec_id", "start", "end", "order"), cols):
            g, e = col.numpy(), getattr(exp, name)
            assert g.dtype == e.dtype, name
            np.testing.assert_array_equal(g, e, err_msg=name)
        _, lay = place_columns(cols, store.num_records, C, 1)
        for g, e in ((lay.rec_offsets, exp.rec_offsets), (lay.longest, exp.max_interval_len)):
            assert g.dtype == e.dtype
            np.testing.assert_array_equal(g, e)


@pytest.mark.parametrize("case", [c for c in CASES if c != "empty_store"])
def test_short_share_is_memo_tpus_gate(case):
    store, _ = _stores(case)
    for below in (1, 30, 100):
        assert short_share(upload_columns(store, "cpu"), below) == float(
            np.mean((store.end - store.start) < below))


def test_composite_keys_that_overflow_int64_raise():
    store = IntervalStore(record_names=["chr0"], record_lens=[1 << 42], n_docs=1 << 21,
                          kind="conservation", rec_id=[0], start=[0], end=[1 << 42], order=[0])
    with pytest.raises(OverflowError, match="overflow int64"):
        place_store_and_layout(store, "cpu", 1)


@pytest.fixture(scope="module")
def mixed_store():
    """Half short and half long intervals: splits into at least 3 buckets."""
    rng = np.random.default_rng(13)
    mix = np.where(rng.random((900, 8)) < 0.5, rng.integers(0, 40, (900, 8)),
                   rng.integers(100, 3000, (900, 8))).astype(np.int32)
    return store_from_ms([_lipschitz(mix), _lipschitz(mix[:400])], ["chrA", "chrB"], [900, 400],
                         9, "conservation")


@pytest.mark.parametrize("k", [3, 31, 101])
@pytest.mark.parametrize("stratify", [True, False], ids=["stratified", "whole"])
@pytest.mark.parametrize("backend", ["fused", "torch"])
def test_engine_outputs_match_numpy_oracle(mixed_store, backend, stratify, k, monkeypatch):
    """The engine places through the torch build and never calls the numpy one."""

    def refuse(*args, **kwargs):
        raise AssertionError("the engine called the numpy QueryLayout.build")

    monkeypatch.setattr(store_mod.QueryLayout, "build", classmethod(refuse))
    eng = QueryEngine(mixed_store, backend=backend, stratify=stratify, device="cpu")
    assert (eng._children is not None) == stratify
    if stratify:
        assert len(eng._children) >= 3
    oracle = JaxEngine(mixed_store, backend="numpy")
    for rec, qs, qe in (("chrA", 0, 900), ("chrA", 123, 456), ("chrB", 0, 400), ("chrB", 399, 400)):
        np.testing.assert_array_equal(eng.conservation(rec, qs, qe, k),
                                      oracle.conservation(rec, qs, qe, k))
    np.testing.assert_array_equal(eng.membership("chrA", 50, 700, k),
                                  oracle.membership("chrA", 50, 700, k))


def _host(out) -> np.ndarray:
    return out.cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)


# memo_tpu's "jax" backend and the port's "torch" are the same diff-array
# ops, each on its own device; "numpy" is common to both.
PORT_BACKEND = {"jax": "torch", "numpy": "numpy"}


@pytest.mark.parametrize("args", [
    ("numpy", 4096),
    ("numpy", 64, 8),
    ("numpy", None, None, True),
    ("jax", 128, 1 << 10, True),
    ("jax", 128, 1 << 10, False, "v2"),
    ("jax", 100, 1 << 10, True, "v2", True),
    ("jax", 256, 1 << 12, False, "v1", False),
], ids=lambda a: "-".join(map(str, a)))
def test_positional_arguments_bind_as_in_memo_tpu(mixed_store, args):
    ref = JaxEngine(mixed_store, *args)
    eng = QueryEngine(mixed_store, PORT_BACKEND[args[0]], *args[1:], device="cpu")
    for attr in ("chunk_positions", "max_intervals", "device_output", "kernel_version"):
        assert getattr(eng, attr) == getattr(ref, attr), attr
    split = [lb for lb, _ in eng._children] if eng._children is not None else None
    assert split == ([lb for lb, _ in ref._children] if ref._children is not None else None)
    for k in (3, 31):
        np.testing.assert_array_equal(_host(eng.conservation("chrA", 10, 900, k)),
                                      _host(ref.conservation("chrA", 10, 900, k)))
        np.testing.assert_array_equal(_host(eng.membership("chrB", 0, 300, k)),
                                      _host(ref.membership("chrB", 0, 300, k)))


def test_signature_is_memo_tpus_with_device_keyword_only():
    mine = list(inspect.signature(QueryEngine).parameters.values())
    theirs = list(inspect.signature(JaxEngine).parameters.values())
    assert [(p.name, p.default, p.kind) for p in mine[: len(theirs)]] == [
        (p.name, p.default, p.kind) for p in theirs
    ]
    assert [(p.name, p.default, p.kind) for p in mine[len(theirs):]] == [
        ("device", "cuda", inspect.Parameter.KEYWORD_ONLY)
    ]


def test_entry_twin_matches_memo_tpu_entry():
    fn, args = entry("cpu")
    assert all(isinstance(a, torch.Tensor) and a.device.type == "cpu" for a in args)
    got = fn(*args)
    ref_fn, ref_args = __graft_entry__.entry()
    want = np.asarray(jax.jit(ref_fn)(*ref_args))
    assert tuple(got.shape) == want.shape == (1024,)
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)
