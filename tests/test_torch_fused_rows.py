"""memo_tpu_torch.ops.fused_query.fused_query_rows: the v1 query read from
the placed store's rows. On the CPU its plain version (prepare_streams, then
fused_query_reference) is held exactly against memo_tpu's engine
(backend "numpy" and "jax") and against memo_query_pallas run in interpret
mode, as memo_tpu's own tests run it (four programs, within the limit of
interpret-mode programs one process may compile). The cases: one window and
a 3-window batch, k in {1, 2, 31}, an empty candidate range, windows at a
record's start and end and running past its end, rows with order < 0 and
order >= C, L not a multiple of the tile, C in {1, 16, 33, 160}, membership
and conservation. A ragged batch (each window over its own length, one
packed output) equals, for v1 and v2, the batch at its longest length cut to
each window's length, and memo_tpu's numpy engine. The ``cuda`` twins run
the kernel against the plain version on the card and skip here. Tolerance:
exact (integer outputs)."""

import numpy as np
import pytest
import torch
from test_pallas import _store

from memo_tpu.query.engine import QueryEngine as JaxEngine
from memo_tpu_torch import IntervalStore
from memo_tpu_torch.ops import fused_query, fused_query_v2
from memo_tpu_torch.ops.fused_query import (
    Offsets,
    fused_query_reference,
    fused_query_rows,
    fused_query_rows_reference,
    kernel_constants,
    prepare_streams,
    rows_tile,
)
from memo_tpu_torch.ops.fused_query_v2 import fused_query_v2_rows
from memo_tpu_torch.query.engine import QueryEngine
from memo_tpu_torch.query.window import ragged_table

REC_LEN = 1500
WIDTHS = (1, 16, 33, 160)
KS = (1, 2, 31)
# (record, qs, qe): a record's start, its end, one position, a record with no rows.
WINDOWS = (("chr0", 0, 300), ("chr0", 1423, 1500), ("chr1", 555, 556), ("chr2", 0, 100))
# One batch of chr0 at the longest length, 300: the second window runs 250
# positions past the record's end.
BATCH = ((0, 300), (1450, 1500), (700, 701))


def random_store(rng, C: int, kind: str = "conservation", rec_len: int = REC_LEN,
                 per_pos: int = 3, cls=IntervalStore):
    """Random intervals on chr0 and chr1 (chr2 has none), most short enough
    to mark at k=31, ends up to 2x past the record, 5% of orders -1 and 5%
    >= C (dropped rows; they also send prefix_counts down its scan path)."""
    rows = []
    for r, n in ((0, rec_len * per_pos), (1, rec_len * per_pos), (2, 0)):
        start = rng.integers(0, rec_len, n)
        span = np.where(rng.random(n) < 0.7, rng.integers(0, 40, n), rng.integers(40, rec_len, n))
        order = rng.integers(0, C, n)
        bad = rng.random(n)
        order[bad < 0.05] = -1
        order[bad > 0.95] = C + rng.integers(0, 3, int((bad > 0.95).sum()))
        rows.append((np.full(n, r), start, start + span, order))
    rec, start, end, order = (np.concatenate(c) for c in zip(*rows))
    keep = np.lexsort((end, start, rec))
    return cls(record_names=["chr0", "chr1", "chr2"], record_lens=[rec_len] * 3, n_docs=C,
               kind=kind, rec_id=rec[keep], start=start[keep], end=end[keep], order=order[keep])


@pytest.fixture(scope="module")
def stores():
    rng = np.random.default_rng(41)
    return {(C, kind): random_store(rng, C, kind) for C in WIDTHS
            for kind in ("conservation", "membership")}


def _rows(eng: QueryEngine, record: str, wins, k: int, membership: bool, **kw):
    """fused_query_rows on ``wins`` of one record, all at the longest length,
    with the ranges and the prefix the engine finds on its device."""
    L = max(qe - qs for qs, qe in wins)
    args = eng._window_params(record, [qs for qs, _ in wins], L, k)[:2]
    C = eng.n_docs
    out = fused_query_rows(eng._d, *args, k=k, L=L, C=C, n_docs=C, membership=membership, **kw)
    return out, args, L


@pytest.mark.parametrize("kind", ["conservation", "membership"])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("C", WIDTHS)
def test_rows_match_numpy_engine(stores, C, k, kind):
    store = stores[(C, kind)]
    membership = kind == "membership"
    eng = QueryEngine(store, device="cpu", stratify=False)
    oracle = JaxEngine(store, backend="numpy")
    jeng = JaxEngine(store, backend="pallas", stratify=False)
    for record, qs, qe in WINDOWS:
        params = eng._window_params(record, [qs], qe - qs, k).params
        assert params[0, :4].tolist() == list(jeng._window_params(record, qs, qe, k)[:4])
        got, _, _ = _rows(eng, record, [(qs, qe)], k, membership)
        want = getattr(oracle, kind)(record, qs, qe, k)
        assert got.shape == (1,) + want.shape
        assert got.dtype == (torch.int8 if membership else torch.int32)
        np.testing.assert_array_equal(got[0].numpy(), want, err_msg=f"{record}:{qs}-{qe}")
    got, _, L = _rows(eng, "chr0", BATCH, k, membership)
    assert got.shape[:2] == (len(BATCH), L)
    for row, (qs, _) in zip(got, BATCH):
        np.testing.assert_array_equal(row.numpy(), getattr(oracle, kind)("chr0", qs, qs + L, k))


def test_empty_ranges_give_the_prefix_alone(stores):
    """A window whose candidate ranges are empty reads no row: the output is
    the prefix alone, here nothing marked."""
    eng = QueryEngine(stores[(16, "conservation")], device="cpu", stratify=False)
    mlo, mhi, plo, phi, _ = eng._window_params("chr2", [0], 100, 31).params[0].tolist()
    assert mlo == mhi and plo == phi
    got, _, _ = _rows(eng, "chr2", [(0, 100)], 31, False)
    assert (got == 16).all()


@pytest.mark.parametrize("C", [16, 160])
def test_rows_match_jax_backend(stores, C):
    for kind in ("conservation", "membership"):
        store = stores[(C, kind)]
        eng = QueryEngine(store, device="cpu", stratify=False)
        jax_eng = JaxEngine(store, backend="jax", stratify=False)
        for record, qs, qe in (WINDOWS[0], WINDOWS[1]):
            got, _, _ = _rows(eng, record, [(qs, qe)], 31, kind == "membership")
            np.testing.assert_array_equal(got[0].numpy(), getattr(jax_eng, kind)(record, qs, qe, 31))


# Four interpret-mode programs: a true-MS store (prefix_counts' monotone
# path) and a random one (its scan path), both kinds, C = 6 / 16 / 33.
PALLAS_CASES = [
    ("ms", 6, "conservation", ("chr0", 0, 700), 31),
    ("ms", 6, "membership", ("chr1", 600, 700), 2),
    ("random", 16, "conservation", ("chr0", 1423, 1500), 1),
    ("random", 33, "membership", ("chr0", 0, 300), 31),
]


@pytest.mark.parametrize("source,C,kind,window,k", PALLAS_CASES)
def test_rows_match_pallas_interpret(stores, source, C, kind, window, k):
    import jax.numpy as jnp

    from memo_tpu.ops.pallas_query import kernel_constants_for, memo_query_pallas
    from memo_tpu.query.engine import _next_pow2

    if source == "ms":
        store = _store(np.random.default_rng(3), True, kind=kind, n_records=2, n_docs=C, rec_len=700)
        assert store.query_layout().monotone
    else:
        store = stores[(C, kind)]
        assert not store.query_layout().monotone
    record, qs, qe = window
    L, membership = qe - qs, kind == "membership"
    jeng = JaxEngine(store, backend="pallas", stratify=False)
    mlo, mhi, plo, phi, prefix = jeng._window_params(record, qs, qe, k)
    M = min(_next_pow2(max(mhi - mlo, phi - plo, 1)), jeng.max_intervals)
    tile, ev_rows = kernel_constants_for(M, L)
    jprefix = np.zeros((1, max((C + 127) // 128 * 128, 128)), np.int32)
    jprefix[0, :C] = prefix
    want = memo_query_pallas(
        jeng._d_start, jeng._d_end, jeng._d_order,
        jeng._d_end_s, jeng._d_start_by_end, jeng._d_order_by_end,
        jnp.asarray(jprefix), *(jnp.int32(x) for x in (mlo, mhi, plo, phi, qs)), jnp.int32(k),
        M=M, L=L, C=C, n_docs=C, membership=membership, interpret=True, tile=tile, ev_rows=ev_rows,
    )
    got, _, _ = _rows(QueryEngine(store, device="cpu", stratify=False), record, [(qs, qe)], k,
                      membership)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


def test_window_args_is_one_tensor(stores):
    """The window step's parameter block int32[Q, 5], candidate counts
    int32[2, Q] and prefix int32[Q, C] are contiguous views of one int32
    tensor (the kernel's layout; the card twin is in
    test_torch_window_params_card.py), and agree with memo_tpu's host
    search."""
    store = stores[(33, "conservation")]
    eng = QueryEngine(store, device="cpu", stratify=False)
    jeng = JaxEngine(store, backend="pallas", stratify=False)
    L = max(qe - qs for qs, qe in BATCH)
    wp = eng._window_params("chr0", [qs for qs, _ in BATCH], L, 31)
    shapes = [(len(BATCH), 5), (len(BATCH), 33), (2, len(BATCH))]
    assert [tuple(t.shape) for t in wp] == shapes
    assert all(t.dtype == torch.int32 and t.is_contiguous() for t in wp)
    assert len({t.untyped_storage().data_ptr() for t in wp}) == 1
    for i, (qs, _) in enumerate(BATCH):
        mlo, mhi, plo, phi, prefix = jeng._window_params("chr0", qs, qs + L, 31)
        assert wp.params[i].tolist() == [mlo, mhi, plo, phi, qs]
        assert wp.counts[:, i].tolist() == [mhi - mlo, phi - plo]
        np.testing.assert_array_equal(wp.prefix[i].numpy(), prefix)


def test_reference_is_prepare_streams_then_the_diff_array(stores):
    """The plain version is prepare_streams over the largest candidate range
    followed by fused_query_reference, whatever M the engine would pick."""
    eng = QueryEngine(stores[(33, "conservation")], device="cpu", stratify=False)
    got, (params, prefix), L = _rows(eng, "chr0", BATCH, 31, False)
    mlo, mhi, plo, phi, qs = params.numpy().T
    streams = prepare_streams(*eng._d, mlo, mhi, plo, phi, qs, 31, M=4096, L=L, C=33,
                              tile=kernel_constants(33))
    assert torch.equal(got, fused_query_reference(streams, prefix, n_docs=33, membership=False))


# Ragged batches of chr0: (windows, MAX_WINDOWS, MAX_COLUMNS), each limit
# lowered where the case wants more launch groups (C = 16: groups of 5 columns).
RAGGED = {
    "empty-mixed": ([(0, 300), (5, 5), (1450, 1500), (700, 700), (700, 701)], None, None),
    "1-to-50x": ([(40 * i, 40 * i + n) for i, n in enumerate((1, 6, 8, 10, 10, 12, 30, 500))],
                 None, None),
    "window-groups": ([(0, 7), (7, 7), (30, 330), (900, 901), (1200, 1260), (1490, 1500),
                       (64, 128)], 2, None),
    "column-groups": ([(0, 300), (299, 300), (1000, 1257), (20, 20), (555, 600)], None, 5),
}


@pytest.mark.parametrize("case", RAGGED)
@pytest.mark.parametrize("kind", ["conservation", "membership"])
@pytest.mark.parametrize("version", ["v1", "v2"])
def test_ragged_rows_equal_padded_rows_cut(stores, monkeypatch, version, kind, case):
    """The wrapper with a ragged batch's offsets: one packed output, each
    window's run of it equal to the uniform call at the longest length cut
    to the window's length, and to memo_tpu's numpy engine, through window
    and column groups too."""
    wins, max_windows, max_columns = RAGGED[case]
    if max_windows:
        monkeypatch.setattr(fused_query, "MAX_WINDOWS", max_windows)
    if max_columns:
        monkeypatch.setattr(fused_query, "MAX_COLUMNS", max_columns)
        monkeypatch.setattr(fused_query_v2, "MAX_COLUMNS", max_columns)
    C, membership = 16, kind == "membership"
    store = stores[(C, kind)]
    eng = QueryEngine(store, device="cpu", stratify=False)
    oracle = JaxEngine(store, backend="numpy")
    run = fused_query_rows if version == "v1" else fused_query_v2_rows
    lengths = [qe - qs for qs, qe in wins]
    L = max(lengths)
    starts = [qs for qs, _ in wins]
    wp = eng._window_params("chr0", starts, L, 31)
    kw = dict(k=31, L=L, C=C, n_docs=C, membership=membership)
    padded = run(eng._d, wp.params, wp.prefix, **kw)
    _, offsets = ragged_table(starts, lengths, "cpu")
    packed = run(eng._d, wp.params, wp.prefix, offsets=offsets, **kw)
    assert packed.shape == ((sum(lengths), C) if membership else (sum(lengths),))
    assert packed.dtype == padded.dtype
    at = np.concatenate([[0], np.cumsum(lengths)])
    for i, (qs, qe) in enumerate(wins):
        got = packed[at[i] : at[i + 1]]
        assert torch.equal(got, padded[i, : qe - qs]), (case, qs, qe)
        np.testing.assert_array_equal(got.numpy(), getattr(oracle, kind)("chr0", qs, qe, 31))


def test_ragged_offsets_are_checked(stores):
    """Offsets the kernels cannot take raise before any launch: a window
    longer than L, lengths that go back, the wrong count."""
    eng = QueryEngine(stores[(16, "conservation")], device="cpu", stratify=False)
    wp = eng._window_params("chr0", [0, 100], 50, 31)
    kw = dict(k=31, L=50, C=16, n_docs=16, membership=False)
    for lengths in ([50, 51], [10], [10, 10, 10]):
        offsets = ragged_table([0] * len(lengths), lengths, "cpu")[1]
        with pytest.raises(ValueError, match="offsets"):
            fused_query_rows(eng._d, wp.params, wp.prefix, offsets=offsets, **kw)
    bad = Offsets(np.array([0, 30, 20], np.int64), torch.tensor([0, 30, 20]))
    with pytest.raises(ValueError, match="offsets"):
        fused_query_v2_rows(eng._d, wp.params, wp.prefix, offsets=bad, **kw)


def test_ragged_table_is_one_upload():
    """A ragged batch's starts and offsets are views of one int64 tensor,
    filled from one host array: the window step's starts, then the
    kernels' offsets from 0."""
    starts, offsets = ragged_table([5, 900, 40], [10, 0, 7], "cpu")
    assert starts.tolist() == [5, 900, 40] and offsets.host.tolist() == [0, 10, 10, 17]
    assert torch.equal(offsets.device, torch.from_numpy(offsets.host))
    assert starts.untyped_storage().data_ptr() == offsets.device.untyped_storage().data_ptr()
    assert starts.dtype == offsets.device.dtype == torch.int64 and offsets.total == 17


@pytest.mark.parametrize("C,tile", [(1, 256), (16, 256), (90, 256), (160, 256), (220, 256),
                                    (257, 128), (854, 64)])
def test_rows_tile(C, tile):
    assert rows_tile(C) == tile


def test_rows_tile_rejects_what_v1_rejects():
    with pytest.raises(ValueError, match="at most 854 columns"):
        rows_tile(855)


def test_rows_refuse_tensors_off_cpu_and_cuda():
    z = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fused_query_rows((z,) * 6, z.view(-1, 8)[:, :5], z.view(8, 1), k=3, L=4, C=1, n_docs=1,
                         membership=False)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("C", WIDTHS)
def test_cuda_rows_match_plain(cuda_device, stores, C):
    """The kernel against its plain version on the same device tensors, for
    every window and the batch, each k and kind; one launch per call."""
    for kind in ("conservation", "membership"):
        eng = QueryEngine(stores[(C, kind)], device=cuda_device, stratify=False)
        for k in KS:
            cases = [(record, [(qs, qe)]) for record, qs, qe in WINDOWS] + [("chr0", BATCH)]
            for record, wins in cases:
                before = fused_query_rows.launches
                got, args, L = _rows(eng, record, wins, k, kind == "membership")
                torch.cuda.synchronize()
                assert fused_query_rows.launches == before + 1
                want = fused_query_rows_reference(eng._d, *args, k=k, L=L, C=C, n_docs=C,
                                                  membership=kind == "membership")
                assert torch.equal(got, want), (C, kind, k, record, wins)


@pytest.mark.cuda
def test_cuda_rows_long_window_and_many_windows(cuda_device):
    """A window of 1172 tiles (more than the tile scan's 1024 threads) at
    C=16, a batch of 40 windows, and a dense store with thousands of rows a
    tile, against the plain version."""
    cases = ((random_store(np.random.default_rng(43), 16, rec_len=300_000, per_pos=2),
              ([(0, 300_000)], [(i * 7000, i * 7000 + 9000) for i in range(40)])),
             (random_store(np.random.default_rng(44), 16, rec_len=20_000, per_pos=12),
              ([(0, 20_000)],)))
    for store, windows in cases:
        eng = QueryEngine(store, device=cuda_device, stratify=False)
        for wins in windows:
            got, args, L = _rows(eng, "chr0", wins, 31, False)
            want = fused_query_rows_reference(eng._d, *args, k=31, L=L, C=16, n_docs=16,
                                              membership=False)
            assert torch.equal(got, want), wins[0]


@pytest.mark.cuda
@pytest.mark.parametrize("C", [257, 854])
def test_cuda_rows_narrow_tiles(cuda_device, C):
    """Widths whose tile is 128 and 64 positions, both kinds."""
    for kind in ("conservation", "membership"):
        store = random_store(np.random.default_rng(C), C, kind, rec_len=2000, per_pos=2)
        eng = QueryEngine(store, device=cuda_device, stratify=False)
        for record, wins in (("chr0", [(0, 2000)]), ("chr0", BATCH)):
            got, args, L = _rows(eng, record, wins, 31, kind == "membership")
            want = fused_query_rows_reference(eng._d, *args, k=31, L=L, C=C, n_docs=C,
                                              membership=kind == "membership")
            assert torch.equal(got, want), (C, kind, wins)
