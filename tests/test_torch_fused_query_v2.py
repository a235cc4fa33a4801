"""memo_tpu_torch.ops.fused_query_v2: the plain version of the v2 CUDA
kernel, on the port's streams, held exactly against memo_query_pallas_v2 run
in interpret mode on the CPU (sparse and dense-band stores, a wide store, a
width that is not a multiple of 8, membership). At most 6 interpret-mode
programs are compiled in this file: more in one process can crash the XLA
CPU compiler. The kernel itself runs only on a GPU: its tests carry the
``cuda`` marker and skip here."""

import numpy as np
import pytest
import torch
from test_pallas import _store
from test_torch_fused_query import _random_streams, _window

from memo_tpu.query.engine import _next_pow2
from memo_tpu_torch.ops.fused_query import Streams, prepare_streams
from memo_tpu_torch.ops.fused_query_v2 import (
    fused_query_v2,
    fused_query_v2_reference,
    kernel_constants_v2,
)
from memo_tpu_torch.query.engine import place_store

# (n_docs, kind, rec_len, window, k): sparse n=6 (C not a multiple of 8),
# the dense band store n=60 at rec_len 256 (tens of events per position,
# test_pallas.py:218-227) at two k, a wide n=160 store, and membership.
PALLAS_V2_CASES = [
    (6, "conservation", 700, (0, 700), 3),
    (6, "membership", 500, (3, 490), 7),
    (60, "conservation", 256, (0, 256), 31),
    (60, "conservation", 256, (13, 239), 2),
    (160, "conservation", 300, (0, 300), 31),
]


@pytest.mark.parametrize("n_docs,kind,rec_len,window,k", PALLAS_V2_CASES)
def test_reference_matches_pallas_v2_interpret(n_docs, kind, rec_len, window, k):
    import jax.numpy as jnp

    from memo_tpu.ops.pallas_query_v2 import kernel_constants_v2 as jax_constants
    from memo_tpu.ops.pallas_query_v2 import memo_query_pallas_v2

    rng = np.random.default_rng(n_docs * 7)
    store = _store(rng, True, kind=kind, n_records=1, n_docs=n_docs, rec_len=rec_len)
    if n_docs == 60:
        assert store.num_intervals > 20 * rec_len  # dense: the TPU kernel's band folds
    qs, qe = window
    L, membership = qe - qs, kind == "membership"
    jeng, ranges, M, prefix = _window(store, "chr0", qs, qe, k)
    tile, ev_rows = jax_constants(M, L)
    c_sub = max((n_docs + 7) // 8 * 8, 8)
    jprefix = np.zeros((c_sub, 1), np.int32)
    jprefix[:n_docs, 0] = prefix
    want = memo_query_pallas_v2(
        jeng._d_start, jeng._d_end, jeng._d_order,
        jeng._d_end_s, jeng._d_start_by_end, jeng._d_order_by_end,
        jnp.asarray(jprefix), *(jnp.int32(x) for x in ranges), jnp.int32(qs), jnp.int32(k),
        M=M, L=L, C=n_docs, n_docs=n_docs, membership=membership, interpret=True,
        tile=tile, ev_rows=ev_rows,
    )
    placed = place_store(store, "cpu", _next_pow2(store.num_intervals))
    streams = prepare_streams(*placed, *ranges, qs, k, M=M, L=L, C=n_docs,
                              tile=kernel_constants_v2(n_docs))
    prefix_t = torch.from_numpy(prefix.astype(np.int32))
    got = fused_query_v2(streams, prefix_t, n_docs=n_docs, membership=membership)
    assert got.dtype == (torch.int8 if membership else torch.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cpu_runs_plain_version_and_counts_no_launch():
    rng = np.random.default_rng(4)
    before = fused_query_v2.launches
    for n_win in (1, 3):
        streams, prefix = _random_streams(rng, n_win, 300, 7, 2, kernel_constants_v2(7), "cpu")
        for membership in (False, True):
            got = fused_query_v2(streams, prefix, n_docs=7, membership=membership)
            want = fused_query_v2_reference(streams, prefix, n_docs=7, membership=membership)
            assert torch.equal(got, want)
    assert fused_query_v2.launches == before


def test_refuses_tensors_off_cpu_and_cuda():
    """A tensor that is neither on the CPU nor on a CUDA device never falls
    back to the plain version."""
    z = torch.zeros(4, dtype=torch.int32, device="meta")
    streams = Streams(z, z, z, z, z, z, 4, 256)
    with pytest.raises(ValueError, match="CUDA"):
        fused_query_v2(streams, z, n_docs=4, membership=False)


@pytest.mark.parametrize(
    "C,tile", [(6, 256), (16, 256), (90, 256), (160, 256), (225, 256), (226, 128), (257, 128),
               (447, 128), (448, 64), (880, 64)]
)
def test_kernel_constants_v2(C, tile):
    assert kernel_constants_v2(C) == tile


def test_kernel_constants_v2_rejects_too_wide():
    with pytest.raises(ValueError, match="at most 880 columns"):
        kernel_constants_v2(881)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("C", [6, 16, 90, 129, 160, 257])
@pytest.mark.parametrize("membership", [False, True])
@pytest.mark.parametrize("n_win", [1, 3])
def test_cuda_kernel_matches_reference(cuda_device, C, membership, n_win):
    rng = np.random.default_rng(C + 1000 * n_win)
    tile = kernel_constants_v2(C)
    for L, per_pos in ((1, 2), (777, 3), (37 * tile + 3, 20)):
        streams, prefix = _random_streams(rng, n_win, L, C, per_pos, tile, cuda_device)
        before = fused_query_v2.launches
        got = fused_query_v2(streams, prefix, n_docs=C, membership=membership)
        torch.cuda.synchronize()
        assert fused_query_v2.launches == before + 1
        want = fused_query_v2_reference(streams, prefix, n_docs=C, membership=membership)
        assert torch.equal(got, want), (C, L, membership, n_win)
