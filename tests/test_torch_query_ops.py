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
