"""memo_tpu_torch.ops.fused_query: the stream set-up and the plain version
of the CUDA kernel, held exactly against memo_query_pallas run in interpret
mode on the CPU, for one window and for a batch. At most 8 interpret-mode
programs are compiled in this file
(more in one process can crash the XLA CPU compiler). The CUDA kernel itself
runs only on a GPU: its test carries the ``cuda`` marker and skips here.

JAX is imported inside the tests that use it, so that the ``cuda`` test runs
where JAX is not installed (``MEMO_TPU_TEST_REAL_DEVICE=1`` keeps
tests/conftest.py from importing it)."""

import numpy as np
import pytest
import torch
from test_pallas import _store

from memo_tpu.query.engine import QueryEngine as JaxEngine
from memo_tpu.query.engine import _next_pow2
from memo_tpu_torch.ops import _build
from memo_tpu_torch.ops.fused_query import (
    Streams,
    fused_query,
    fused_query_reference,
    kernel_constants,
    prepare_streams,
)
from memo_tpu_torch.query.engine import place_store


def _window(store, record, qs, qe, k):
    """Candidate ranges, bucket and prefix of one window, from the JAX
    engine's own host-side search."""
    jeng = JaxEngine(store, backend="pallas", stratify=False)
    mlo, mhi, plo, phi, prefix = jeng._window_params(record, qs, qe, k)
    M = min(_next_pow2(max(mhi - mlo, phi - plo, 1)), jeng.max_intervals)
    return jeng, (mlo, mhi, plo, phi), M, prefix


def _random_streams(rng, n_win, L, C, per_pos, tile, device):
    """Sorted random event streams over L positions (val 0 = inert) with a
    dead tail parked at L_pad, and a random prefix: 1-D for one window,
    one row per window for n_win > 1."""
    l_pad = -(-L // tile) * tile
    bounds = np.arange(0, l_pad + 1, tile)
    rows = {name: [] for name in ("pos_m", "val_m", "off_m", "pos_p", "val_p", "off_p")}
    for _ in range(n_win):
        for suffix in ("m", "p"):
            pos = np.sort(rng.integers(0, L, L * per_pos))
            pos = np.concatenate([pos, np.full(5, l_pad)]).astype(np.int32)
            rows[f"pos_{suffix}"].append(pos)
            rows[f"val_{suffix}"].append(rng.integers(0, C + 1, pos.size).astype(np.int32))
            rows[f"off_{suffix}"].append(np.searchsorted(pos, bounds).astype(np.int32))
    prefix = rng.integers(0, 3, (n_win, C)).astype(np.int32)
    pick = (lambda a: a[0]) if n_win == 1 else np.stack
    parts = [torch.from_numpy(pick(v)).to(device) for v in rows.values()]
    return Streams(*parts, L, tile), torch.from_numpy(pick(prefix)).to(device)


def _port(store, ranges, qs, k, M, L, prefix, membership):
    n = store.n_docs
    placed = place_store(store, "cpu", _next_pow2(max(store.num_intervals, 1)))
    streams = prepare_streams(*placed, *ranges, qs, k, M=M, L=L, C=n, tile=kernel_constants(n))
    prefix_t = torch.from_numpy(prefix.astype(np.int32))
    return streams, fused_query_reference(streams, prefix_t, n_docs=n, membership=membership)


# Six interpret-mode programs: both store kinds, n_docs 6 and 129 (one and
# two 128-lane column blocks on the TPU), k in {1, 3, 31}, windows that
# start at, inside and at the end of a record.
PALLAS_CASES = [
    (6, "conservation", True, ("chr0", 0, 700), 3),
    (6, "conservation", False, ("chr0", 123, 456), 31),
    (6, "conservation", True, ("chr1", 600, 700), 1),
    (6, "membership", True, ("chr0", 0, 700), 3),
    (129, "conservation", True, ("chr0", 0, 300), 31),
    (129, "membership", True, ("chr0", 77, 204), 3),
]


@pytest.mark.parametrize("n_docs,kind,lipschitz,window,k", PALLAS_CASES)
def test_reference_matches_pallas_interpret(n_docs, kind, lipschitz, window, k):
    import jax.numpy as jnp

    from memo_tpu.ops.pallas_query import kernel_constants_for, memo_query_pallas

    rng = np.random.default_rng(3)
    n_records, rec_len = (2, 700) if n_docs == 6 else (1, 300)
    store = _store(rng, lipschitz, kind=kind, n_records=n_records, n_docs=n_docs, rec_len=rec_len)
    record, qs, qe = window
    L, membership = qe - qs, kind == "membership"
    jeng, ranges, M, prefix = _window(store, record, qs, qe, k)
    tile, ev_rows = kernel_constants_for(M, L)
    c_pad = max((n_docs + 127) // 128 * 128, 128)
    jprefix = np.zeros((1, c_pad), np.int32)
    jprefix[0, :n_docs] = prefix
    want = memo_query_pallas(
        jeng._d_start, jeng._d_end, jeng._d_order,
        jeng._d_end_s, jeng._d_start_by_end, jeng._d_order_by_end,
        jnp.asarray(jprefix), *(jnp.int32(x) for x in ranges), jnp.int32(qs), jnp.int32(k),
        M=M, L=L, C=n_docs, n_docs=n_docs, membership=membership, interpret=True,
        tile=tile, ev_rows=ev_rows,
    )
    _, got = _port(store, ranges, qs, k, M, L, prefix, membership)
    assert got.dtype == (torch.int8 if membership else torch.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [1, 3, 31, 101])
def test_prepare_streams_layout(k):
    """Streams hold exactly the live in-window events, sorted, with dead rows
    parked at L_pad, and off[t] is the first event at or past tile t."""
    rng = np.random.default_rng(5)
    store = _store(rng, True, n_records=2, n_docs=6, rec_len=700)
    record, qs, qe = "chr1", 50, 650
    L = qe - qs
    _, (mlo, mhi, plo, phi), M, _ = _window(store, record, qs, qe, k)
    placed = place_store(store, "cpu", _next_pow2(store.num_intervals))
    tile = 64
    s = prepare_streams(*placed, mlo, mhi, plo, phi, qs, k, M=M, L=L, C=6, tile=tile)
    l_pad = -(-L // tile) * tile
    lay = store.query_layout()
    for pos, val, off, lo, hi, p_src, st, en, od, shift in (
        (s.pos_m, s.val_m, s.off_m, mlo, mhi, store.start, store.start, store.end, store.order, qs),
        (s.pos_p, s.val_p, s.off_p, plo, phi, lay.end_sorted, lay.start_by_end, lay.end_sorted,
         lay.order_by_end, qs + k - 1),
    ):
        assert pos.dtype == val.dtype == off.dtype == torch.int32 and pos.numel() == M
        pos, val, off = pos.numpy(), val.numpy(), off.numpy()
        n = hi - lo
        np.testing.assert_array_equal(pos[:n], p_src[lo:hi] - shift)
        assert ((pos[:n] > 0) & (pos[:n] < L)).all()  # candidates lie inside the window
        assert (pos[n:] == l_pad).all() and (val[n:] == 0).all()
        live = (en[lo:hi] - st[lo:hi] < k - 1) & (od[lo:hi] >= 0) & (od[lo:hi] < 6)
        np.testing.assert_array_equal(val[:n], np.where(live, od[lo:hi] + 1, 0))
        assert (np.diff(pos) >= 0).all()
        np.testing.assert_array_equal(off, np.searchsorted(pos, np.arange(0, l_pad + 1, tile)))


def test_prepare_streams_batch_rows_equal_single_windows():
    """Batched streams: row q is the single-window streams of window q, at
    the batch's common L, M and tile."""
    rng = np.random.default_rng(6)
    store = _store(rng, True, n_records=1, n_docs=6, rec_len=700)
    placed = place_store(store, "cpu", _next_pow2(store.num_intervals))
    k, L, M, tile = 31, 260, 512, 64
    wins = [0, 123, 690]  # the last window runs past the record's end
    params = [_window(store, "chr0", qs, qs + L, k)[1] for qs in wins]
    batch = prepare_streams(*placed, *np.array(params).T, wins, k, M=M, L=L, C=6, tile=tile)
    assert batch.pos_m.shape == batch.val_p.shape == (3, M)
    assert batch.off_m.shape == (3, -(-L // tile) + 1)
    for q, (qs, ranges) in enumerate(zip(wins, params)):
        one = prepare_streams(*placed, *ranges, qs, k, M=M, L=L, C=6, tile=tile)
        for got, want in zip(batch[:6], one[:6]):
            assert torch.equal(got[q], want)


def test_reference_batch_rows_equal_single_windows():
    rng = np.random.default_rng(8)
    streams, prefix = _random_streams(rng, 3, 300, 7, 3, kernel_constants(7), "cpu")
    for membership in (False, True):
        batch = fused_query_reference(streams, prefix, n_docs=7, membership=membership)
        for q in range(3):
            one = Streams(*(t[q] for t in streams[:6]), streams.L, streams.tile)
            want = fused_query_reference(one, prefix[q], n_docs=7, membership=membership)
            assert torch.equal(batch[q], want)


def test_fused_query_cpu_runs_plain_version_and_counts_no_launch():
    rng = np.random.default_rng(9)
    L, C, tile = 300, 7, kernel_constants(7)
    parts = []
    for _ in range(2):
        pos = np.sort(rng.integers(0, L, 200)).astype(np.int32)
        val = rng.integers(0, C + 1, 200).astype(np.int32)
        off = np.searchsorted(pos, np.arange(0, L + tile, tile)).astype(np.int32)
        parts += [torch.from_numpy(a) for a in (pos, val, off)]
    streams = Streams(*parts, L, tile)
    prefix = torch.ones(C, dtype=torch.int32)
    before = fused_query.launches
    for membership in (False, True):
        got = fused_query(streams, prefix, n_docs=C, membership=membership)
        want = fused_query_reference(streams, prefix, n_docs=C, membership=membership)
        assert torch.equal(got, want)
    assert fused_query.launches == before


def test_fused_query_refuses_tensors_off_cpu_and_cuda():
    """A tensor that is neither on the CPU nor on a CUDA device never falls
    back to the plain version."""
    z = torch.zeros(4, dtype=torch.int32, device="meta")
    streams = Streams(z, z, z, z, z, z, 4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fused_query(streams, z, n_docs=4, membership=False)


@pytest.mark.parametrize(
    "C,tile", [(6, 256), (16, 256), (90, 256), (129, 256), (160, 256), (257, 128), (854, 64)]
)
def test_kernel_constants(C, tile):
    assert kernel_constants(C) == tile


def test_kernel_constants_rejects_too_wide():
    with pytest.raises(ValueError, match="at most 854 columns"):
        kernel_constants(855)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc, no fallback: the build raises and creates nothing."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_library()
    assert not (tmp_path / "build").exists()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("C", [6, 16, 90, 129, 160, 257])
@pytest.mark.parametrize("membership", [False, True])
def test_cuda_kernel_matches_reference(cuda_device, C, membership):
    rng = np.random.default_rng(C)
    tile = kernel_constants(C)
    for L, per_pos in ((1, 2), (777, 3), (5 * tile + 3, 20)):
        l_pad = -(-L // tile) * tile
        bounds = torch.arange(l_pad // tile + 1, dtype=torch.int32, device=cuda_device) * tile
        parts = []
        for _ in range(2):
            pos = np.sort(rng.integers(0, L, L * per_pos)).astype(np.int32)
            pos = np.concatenate([pos, np.full(5, l_pad, np.int32)])
            val = rng.integers(0, C + 1, pos.size).astype(np.int32)
            p = torch.from_numpy(pos).to(cuda_device)
            parts += [p, torch.from_numpy(val).to(cuda_device),
                      torch.searchsorted(p, bounds, side="left", out_int32=True)]
        streams = Streams(*parts, L, tile)
        prefix = torch.from_numpy(rng.integers(0, 3, C).astype(np.int32)).to(cuda_device)
        before = fused_query.launches
        got = fused_query(streams, prefix, n_docs=C, membership=membership)
        torch.cuda.synchronize()
        assert fused_query.launches == before + 1
        want = fused_query_reference(streams, prefix, n_docs=C, membership=membership)
        assert torch.equal(got, want), (C, L, membership)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [6, 16, 90, 160, 257])
@pytest.mark.parametrize("membership", [False, True])
def test_cuda_kernel_batch_matches_reference(cuda_device, C, membership):
    """Three windows in one launch of each pass."""
    rng = np.random.default_rng(C + 7)
    tile = kernel_constants(C)
    for L, per_pos in ((1, 2), (777, 3), (5 * tile + 3, 20)):
        streams, prefix = _random_streams(rng, 3, L, C, per_pos, tile, cuda_device)
        before = fused_query.launches
        got = fused_query(streams, prefix, n_docs=C, membership=membership)
        torch.cuda.synchronize()
        assert fused_query.launches == before + 1
        want = fused_query_reference(streams, prefix, n_docs=C, membership=membership)
        assert torch.equal(got, want), (C, L, membership)
