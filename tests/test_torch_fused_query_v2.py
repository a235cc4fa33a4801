"""memo_tpu_torch.ops.fused_query_v2.fused_query_v2_rows: the v2 query read
from the placed store's rows. On the CPU it runs its plain version
(fused_query_rows_reference), fed from place_store and the engine's window parameters, and is
held exactly against memo_query_pallas_v2 run in interpret mode on the CPU
(sparse and dense-band stores, a wide store, a width that is not a multiple
of 8, membership). At most 6 interpret-mode programs are compiled in this
file: more in one process can crash the XLA CPU compiler. The kernel itself
runs only on a GPU: its tests carry the ``cuda`` marker and skip here; they
hold it against the plain version on random stores with edge rows.
Tolerance: exact (integer outputs)."""

import numpy as np
import pytest
import torch
from test_pallas import _store
from test_torch_fused_query import _window
from test_torch_fused_rows import BATCH, WINDOWS, random_store

from memo_tpu.query.engine import _next_pow2
from memo_tpu_torch.ops.fused_query import fused_query_rows_reference
from memo_tpu_torch.ops.fused_query_v2 import ROW_SLACK, fused_query_v2_rows, v2_constants
from memo_tpu_torch.query.engine import QueryEngine, place_store

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
def test_rows_match_pallas_v2_interpret(n_docs, kind, rec_len, window, k):
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
    params = torch.tensor([[*ranges, qs]], dtype=torch.int32)
    prefix_t = torch.from_numpy(prefix[None].astype(np.int32))
    got = fused_query_v2_rows(placed, params, prefix_t, k=k, L=L, C=n_docs, n_docs=n_docs,
                              membership=membership)
    assert got.dtype == (torch.int8 if membership else torch.int32)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


def _rows_args(eng: QueryEngine, record: str, wins, k: int):
    """The parameters and prefix of ``wins`` of one record at the longest
    length, found on the engine's device, and that length."""
    L = max(qe - qs for qs, qe in wins)
    return eng._window_params(record, [qs for qs, _ in wins], L, k)[:2], L


def test_cpu_runs_plain_version_and_counts_no_launch():
    store = _store(np.random.default_rng(4), True, n_records=2, n_docs=7, rec_len=300)
    eng = QueryEngine(store, device="cpu", stratify=False, kernel_version="v2")
    before = fused_query_v2_rows.launches
    for wins in ([(0, 300)], [(0, 120), (100, 220), (180, 300)]):
        args, L = _rows_args(eng, "chr1", wins, 5)
        for membership in (False, True):
            got = fused_query_v2_rows(eng._d, *args, k=5, L=L, C=7, n_docs=7,
                                      membership=membership)
            want = fused_query_rows_reference(eng._d, *args, k=5, L=L, C=7, n_docs=7,
                                              membership=membership)
            assert torch.equal(got, want)
    assert fused_query_v2_rows.launches == before


def test_refuses_tensors_off_cpu_and_cuda():
    """A tensor that is neither on the CPU nor on a CUDA device never falls
    back to the plain version."""
    z = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fused_query_v2_rows((z,) * 6, z.view(-1, 8)[:, :5], z.view(8, 1), k=3, L=4, C=1,
                            n_docs=1, membership=False)


def test_engine_leaves_rows_for_bulk_copies():
    """The kernel copies rows in 16-byte runs, up to ROW_SLACK rows past the
    last one a window names: the engine places at least ROW_SLACK + 1
    sentinel rows after the store, however small it is."""
    store = _store(np.random.default_rng(5), True, n_records=1, n_docs=3, rec_len=40)
    one = type(store)(record_names=store.record_names, record_lens=store.record_lens,
                      n_docs=3, kind=store.kind, rec_id=store.rec_id[:1],
                      start=store.start[:1], end=store.end[:1], order=store.order[:1])
    for s in (one, store):
        eng = QueryEngine(s, device="cpu", stratify=False)
        assert all(t.numel() >= s.num_intervals + ROW_SLACK + 1 for t in eng._d)
        assert (eng._d.order[s.num_intervals:] == -1).all()


@pytest.mark.parametrize(
    "C,tile,stages", [(6, 256, 8), (16, 256, 6), (90, 256, 3), (129, 256, 8), (160, 256, 8),
                      (225, 128, 8), (257, 128, 8), (400, 128, 3), (447, 64, 8), (819, 64, 2)]
)
def test_v2_constants(C, tile, stages):
    """The widest tile that leaves room for a ring of two stages, and as
    many stages as fit without costing a block per SM."""
    assert v2_constants(C) == (tile, stages)


def test_v2_constants_rejects_too_wide():
    with pytest.raises(ValueError, match="at most 819 columns"):
        v2_constants(820)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("C", [6, 16, 90, 129, 160, 257])
def test_cuda_rows_match_plain(cuda_device, C):
    """The kernel against its plain version on random stores with dropped
    rows (order < 0 and >= C), for every window of test_torch_fused_rows
    (a record's start and end, one position, an empty record) and its
    3-window batch, k in {1, 2, 31}, both kinds; one launch per call."""
    for kind in ("conservation", "membership"):
        store = random_store(np.random.default_rng(C), C, kind, rec_len=3000)
        eng = QueryEngine(store, device=cuda_device, stratify=False)
        for k in (1, 2, 31):
            cases = [(record, [(qs, qe)]) for record, qs, qe in WINDOWS] + [("chr0", BATCH)]
            for record, wins in cases:
                args, L = _rows_args(eng, record, wins, k)
                before = fused_query_v2_rows.launches
                got = fused_query_v2_rows(eng._d, *args, k=k, L=L, C=C, n_docs=C,
                                          membership=kind == "membership")
                torch.cuda.synchronize()
                assert fused_query_v2_rows.launches == before + 1
                want = fused_query_rows_reference(eng._d, *args, k=k, L=L, C=C, n_docs=C,
                                                  membership=kind == "membership")
                assert torch.equal(got, want), (C, kind, k, record, wins)


@pytest.mark.cuda
def test_cuda_long_and_dense_windows(cuda_device):
    """Long runs (a 300 Kbp window, 40 windows a launch) and a dense store
    with thousands of rows a tile (many ring stages per tile), C=16,
    launched twice in a row (the state words reset themselves)."""
    cases = ((random_store(np.random.default_rng(43), 16, rec_len=300_000, per_pos=2),
              ([(0, 300_000)], [(i * 7000, i * 7000 + 9000) for i in range(40)])),
             (random_store(np.random.default_rng(44), 16, rec_len=20_000, per_pos=12),
              ([(0, 20_000)],)))
    for store, windows in cases:
        eng = QueryEngine(store, device=cuda_device, stratify=False)
        for wins in windows:
            args, L = _rows_args(eng, "chr0", wins, 31)
            want = fused_query_rows_reference(eng._d, *args, k=31, L=L, C=16, n_docs=16,
                                              membership=False)
            for _ in range(2):
                got = fused_query_v2_rows(eng._d, *args, k=31, L=L, C=16, n_docs=16,
                                          membership=False)
                assert torch.equal(got, want), wins[0]
