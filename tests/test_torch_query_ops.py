"""memo_tpu_torch.ops.query_ops == memo_tpu.ops.query_ops (JAX on the CPU),
exactly, on the same seeded inputs: candidate intervals with rows that clip
out of the window and rows whose order lies outside [0, C)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from memo_tpu.ops import query_ops as JQ
from memo_tpu_torch.ops import query_ops as TQ

# (seed, L, C, k): one position, a narrow window, a window wider than most
# intervals at k=31; seeds vary the intervals over the same compiled shapes.
CASES = [
    (seed, L, C, k)
    for seed in (0, 1)
    for L, C, k in ((1, 1, 1), (37, 6, 3), (64, 17, 31))
]
M = 96  # candidate rows per case


def _inputs(seed, L, C):
    rng = np.random.default_rng(seed)
    qs = int(rng.integers(0, 20))
    starts = rng.integers(0, qs + L + 40, M).astype(np.int32)
    ends = (starts + rng.integers(0, 50, M)).astype(np.int32)
    orders = rng.integers(-1, C + 2, M).astype(np.int32)
    return qs, starts, ends, orders


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("seed,L,C,k", CASES)
def test_cast_and_clip_matches_jax(seed, L, C, k):
    qs, s, e, _ = _inputs(seed, L, C)
    got = TQ.cast_and_clip(_t(s), _t(e), qs, L, k)
    want = JQ.cast_and_clip(jnp.asarray(s), jnp.asarray(e), qs, L, k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed,L,C,k", CASES)
def test_coverage_counts_matches_jax(seed, L, C, k):
    qs, s, e, o = _inputs(seed, L, C)
    got = TQ.coverage_counts(_t(s), _t(e), _t(o), qs, k, L=L, C=C)
    want = JQ.coverage_counts(jnp.asarray(s), jnp.asarray(e), jnp.asarray(o), qs, k, L=L, C=C)
    assert got.dtype == torch.int32 and got.shape == (L, C)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed,L,C,k", CASES)
def test_conservation_window_matches_jax(seed, L, C, k):
    qs, s, e, o = _inputs(seed, L, C)
    got = TQ.conservation_window(_t(s), _t(e), _t(o), qs, k, L=L, C=C, n_docs=C)
    want = JQ.conservation_window(
        jnp.asarray(s), jnp.asarray(e), jnp.asarray(o), qs, k, L=L, C=C, n_docs=C
    )
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed,L,C,k", CASES)
def test_membership_window_matches_jax(seed, L, C, k):
    qs, s, e, o = _inputs(seed, L, C)
    got = TQ.membership_window(_t(s), _t(e), _t(o), qs, k, L=L, C=C)
    want = JQ.membership_window(jnp.asarray(s), jnp.asarray(e), jnp.asarray(o), qs, k, L=L, C=C)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed,L,C,k", CASES)
def test_numpy_twins_match_jax_module(seed, L, C, k):
    qs, s, e, o = _inputs(seed, L, C)
    got = TQ.coverage_marks_np(s, e, o, qs, k, L, C)
    want = JQ.coverage_marks_np(s, e, o, qs, k, L, C)
    np.testing.assert_array_equal(got, want)
    cons = TQ.conservation_np(got, C)
    assert cons.dtype == np.int64
    np.testing.assert_array_equal(cons, JQ.conservation_np(want, C))
    np.testing.assert_array_equal(TQ.membership_np(got), JQ.membership_np(want))


@pytest.mark.parametrize("rows,n", [(1, 1), (1, 9), (5, 1), (16, 333)])
def test_row_cumsum_matches_numpy(rows, n):
    x = np.random.default_rng(rows * n).integers(-3, 4, (rows, n)).astype(np.int32)
    got = TQ.row_cumsum(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.cumsum(x, axis=1))


@pytest.mark.parametrize("L,C,k", [(1, 1, 1), (37, 6, 3), (64, 17, 31)])
def test_window_batch_matches_jax_vmap(L, C, k):
    """The window dimension of coverage_counts and its reductions ==
    memo_tpu's jax.vmap over windows (memo_tpu/parallel/sharded.py:99-116)."""
    import jax

    ins = [_inputs(seed, L, C) for seed in range(3)]
    qs = np.array([i[0] for i in ins], np.int32)
    s, e, o = (np.stack([i[j] for i in ins]) for j in (1, 2, 3))
    got = TQ.coverage_counts(_t(s), _t(e), _t(o), qs.tolist(), k, L=L, C=C)
    want = jax.vmap(lambda s, e, o, b: JQ.coverage_counts(s, e, o, b, k, L=L, C=C))(s, e, o, qs)
    assert got.dtype == torch.int32 and got.shape == (3, L, C)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    marks = np.asarray(want) > 0
    np.testing.assert_array_equal(
        TQ.conservation_from_marks(got > 0, C).numpy(),
        np.asarray(jax.vmap(lambda m: JQ.conservation_from_marks(m, C))(marks)),
    )
    np.testing.assert_array_equal(
        TQ.membership_from_marks(got > 0).numpy(),
        np.asarray(jax.vmap(JQ.membership_from_marks)(marks)),
    )


def _mostly_dropped(rng, L, C, qs, M=4000):
    """Candidate rows of which about nine in ten have an order outside [0, C)
    and many more clip out of the window."""
    starts = rng.integers(qs - 30, qs + L + 30, M)
    ends = starts + rng.integers(0, 8, M)
    orders = rng.integers(0, C, M)
    dead = rng.random(M) < 0.9
    orders[dead] = np.where(rng.random(dead.sum()) < 0.5, -1 - rng.integers(0, 3, dead.sum()),
                            C + rng.integers(0, 3, dead.sum()))
    return starts.astype(np.int32), ends.astype(np.int32), orders.astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_mostly_dropped_rows_match_numpy_twins(seed):
    rng = np.random.default_rng(seed)
    L, C, k, qs = 50, 5, 3, 100
    s, e, o = _mostly_dropped(rng, L, C, qs)
    want = TQ.coverage_marks_np(s, e, o, qs, k, L, C)
    assert want.any() and not want.all()
    got = TQ.coverage_marks(_t(s), _t(e), _t(o), qs, k, L=L, C=C)
    np.testing.assert_array_equal(got.numpy(), want)
    batch = TQ.coverage_marks(_t(np.stack([s, s])), _t(np.stack([e, e])), _t(np.stack([o, o])),
                              [qs, qs + 7], k, L=L, C=C)
    np.testing.assert_array_equal(batch[0].numpy(), want)
    np.testing.assert_array_equal(batch[1].numpy(), TQ.coverage_marks_np(s, e, o, qs + 7, k, L, C))
    np.testing.assert_array_equal(TQ.conservation_from_marks(got, C).numpy(), TQ.conservation_np(want, C))
    np.testing.assert_array_equal(TQ.membership_from_marks(got).numpy(), TQ.membership_np(want))


def test_reference_with_mostly_dead_events_matches_numpy():
    """fused_query_reference on streams whose events are mostly inert
    (val 0 or > C) or parked past the window."""
    from memo_tpu_torch.ops.fused_query import Streams, fused_query_reference

    rng = np.random.default_rng(5)
    L, C, tile = 90, 6, 64
    parts, cov = [], np.zeros((L, C), np.int64)
    for sign in (-1, 1):
        pos = np.sort(rng.integers(0, L + 40, 3000)).astype(np.int32)
        val = np.where(rng.random(pos.size) < 0.9, rng.choice([0, C + 1, C + 5], pos.size),
                       rng.integers(1, C + 1, pos.size)).astype(np.int32)
        live = (val >= 1) & (val <= C) & (pos < L)
        np.add.at(cov, (pos[live], val[live] - 1), sign)
        off = np.searchsorted(pos, np.arange(0, 2 * tile + 1, tile)).astype(np.int32)
        parts += [_t(pos), _t(val), _t(off)]
    prefix = rng.integers(0, 40, C).astype(np.int32)
    marks = prefix + np.cumsum(cov, axis=0) > 0
    streams = Streams(*parts[:3], *parts[3:], L, tile)
    np.testing.assert_array_equal(
        fused_query_reference(streams, _t(prefix), n_docs=C, membership=False).numpy(),
        TQ.conservation_np(marks, C),
    )
    np.testing.assert_array_equal(
        fused_query_reference(streams, _t(prefix), n_docs=C, membership=True).numpy(),
        TQ.membership_np(marks),
    )


def test_torch_backend_drops_rows_past_the_record_end():
    """Windows at the end of a record read rows of the next record, which
    the torch backend masks (memo_tpu engine.py:724-728)."""
    from test_pallas import _store

    from memo_tpu.query.engine import QueryEngine as JaxEngine
    from memo_tpu_torch.query.engine import QueryEngine

    store = _store(np.random.default_rng(12), True, n_records=2, n_docs=6, rec_len=300)
    eng = QueryEngine(store, backend="torch", device="cpu")
    oracle = JaxEngine(store, backend="numpy")
    for qs, qe, k in [(290, 300, 1), (250, 300, 31), (299, 300, 3)]:
        np.testing.assert_array_equal(
            eng.conservation("chr0", qs, qe, k), oracle.conservation("chr0", qs, qe, k)
        )
