"""memo_tpu_torch.ops.fused_query: the stream set-up and the plain version
of the v1 kernel, held exactly against memo_query_pallas run in interpret
mode on the CPU, for one window and for a batch. At most 8 interpret-mode
programs are compiled in this file
(more in one process can crash the XLA CPU compiler). The CUDA kernel
(fused_query_rows, which reads the placed store's rows) runs only on a GPU:
its tests carry the ``cuda`` marker and skip here; tests/test_torch_fused_rows.py
holds its plain version against memo_tpu.

JAX is imported inside the tests that use it, so that the ``cuda`` tests run
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
    fused_query_reference,
    fused_query_rows,
    fused_query_rows_reference,
    kernel_constants,
    prepare_streams,
)
from memo_tpu_torch.query.engine import QueryEngine, place_store


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
    """fused_query_rows on CPU tensors is its plain version and launches
    nothing."""
    store = _store(np.random.default_rng(9), True, n_records=2, n_docs=7, rec_len=300)
    eng = QueryEngine(store, device="cpu", stratify=False)
    args = eng._window_params("chr1", (0, 100, 180), 120, 5)[:2]
    before = fused_query_rows.launches
    for membership in (False, True):
        got = fused_query_rows(eng._d, *args, k=5, L=120, C=7, n_docs=7, membership=membership)
        want = fused_query_rows_reference(eng._d, *args, k=5, L=120, C=7, n_docs=7,
                                          membership=membership)
        assert torch.equal(got, want)
    assert fused_query_rows.launches == before


def test_fused_query_refuses_tensors_off_cpu_and_cuda():
    """A tensor that is neither on the CPU nor on a CUDA device never falls
    back to the plain version."""
    z = torch.zeros(5, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fused_query_rows((z,) * 6, z.view(1, 5), z.view(1, 5), k=3, L=4, C=5, n_docs=5,
                         membership=False)


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


def _store_windows(C: int, seed: int, n_win: int):
    """A 2-record true-MS store of width C and n_win windows of chr1, run at
    the longest length (so past the record's end)."""
    store = _store(np.random.default_rng(seed), True, n_records=2, n_docs=C, rec_len=1800)
    return store, [(0, 1800), (1234, 1800), (1799, 1800)][:n_win]


@pytest.mark.cuda
@pytest.mark.parametrize("C", [6, 16, 90, 129, 160, 257])
@pytest.mark.parametrize("membership", [False, True])
def test_cuda_kernel_matches_reference(cuda_device, C, membership):
    """The row kernel against its plain version on the card, one window."""
    _check_rows_kernel(cuda_device, C, membership, n_win=1)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [6, 16, 90, 160, 257])
@pytest.mark.parametrize("membership", [False, True])
def test_cuda_kernel_batch_matches_reference(cuda_device, C, membership):
    """Three windows in one launch."""
    _check_rows_kernel(cuda_device, C, membership, n_win=3)


def _check_rows_kernel(device, C, membership, n_win):
    store, wins = _store_windows(C, C + 7 * n_win, n_win)
    eng = QueryEngine(store, device=device, stratify=False)
    for k in (1, 3, 31, 101):
        L = max(qe - qs for qs, qe in wins)
        args = eng._window_params("chr1", [qs for qs, _ in wins], L, k)[:2]
        before = fused_query_rows.launches
        got = fused_query_rows(eng._d, *args, k=k, L=L, C=C, n_docs=C, membership=membership)
        torch.cuda.synchronize()
        assert fused_query_rows.launches == before + 1
        want = fused_query_rows_reference(eng._d, *args, k=k, L=L, C=C, n_docs=C,
                                          membership=membership)
        assert torch.equal(got, want), (C, k, membership)
