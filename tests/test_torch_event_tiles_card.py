"""v1's conservation apply on the card (``cuda`` tests; they skip where no
CUDA device exists). A launch splits its tiles where that pays
(``fused_query.event_rows``: enough columns that its dense kernel keeps
the one-block kernel's occupancy, and a tile for each event warp the card
holds): a tile of few candidate rows is finished on the event path (one
warp, its events walked in position order), a denser one on the dense
path, each in a kernel of its own, and the event path runs only where it
was given a tile for each of its warps. Other launches run the one-block
kernel alone (``csrc/fused_query.cu``). Whatever path a tile takes, the
output equals the plain version exactly:

- stores of the chromosome's sparse recipe and of the MHC's dense one;
- one launch whose tiles fall on both sides of the threshold;
- a launch that splits but lists too few tiles for the event path;
- launches that do not split: few tiles, or few columns (C = 16);
- tiles with no event and a positive carry; events on a tile's first and
  last position; a tile past any event budget (5,000 candidate rows);
- ragged batches with an empty window and single positions;
- column groups (C = 1000: two launches, the second from c0 = 500);
- k = 2, 31 and 101;

in uniform and ragged launches. While a profiler records, a launch counts
its tiles (``memo.apply_tiles``) and those of the event path
(``memo.event_tiles``, at most as many, 0 where it did not run); untraced,
it counts nothing. Imports no JAX: ``MEMO_TPU_TEST_REAL_DEVICE=1 python -m
pytest -m cuda tests/test_torch_event_tiles_card.py``. Tolerance: exact
(integers)."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from window_cases import lipschitz

from memo_tpu_torch import QueryEngine
from memo_tpu_torch.index.builder import store_from_ms
from memo_tpu_torch.index.store import IntervalStore
from memo_tpu_torch.ops import fused_query
from memo_tpu_torch.ops.fused_query import fused_query_rows, fused_query_rows_reference
from memo_tpu_torch.query.window import ragged_table
from memo_tpu_torch.utils import profiling

REC_LEN = 120_000
DENSE_BUDGET = 5_000  # candidate rows of one tile, past any event budget (fits 12 bits of rank)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run there")
    return torch.device("cuda")


def synth(rng, rec_len, n_cols, gap):
    import chip_smoke

    return chip_smoke.synth_ms(rng, rec_len, n_cols, 31, gap=gap)


@pytest.fixture(scope="module")
def stores():
    """Conservation stores over REC_LEN positions at 90 genomes: the
    chromosome's recipe (gap 1100), the MHC's (gap 25), and one twice as
    dense as the MHC on its first half (past the event path's rows in most
    tiles) and sparse on its second."""
    rng = np.random.default_rng(24)
    sparse = synth(rng, REC_LEN, 89, 1100)
    dense = synth(rng, REC_LEN, 89, 25)
    half = REC_LEN // 2
    mixed = lipschitz(np.concatenate([synth(rng, half, 89, 12), sparse[half:]]))
    return {name: store_from_ms([ms], ["chr1"], [REC_LEN], 90, "conservation")
            for name, ms in (("sparse", sparse), ("dense", dense), ("mixed", mixed))}


def edge_store(C: int, T: int, k: int, seed: int) -> IntervalStore:
    """Rows of C columns over REC_LEN whose minus or plus events fall on a
    T-tile's first or last position, sparse runs of marked positions longer
    than a tile (no event inside a tile, a positive carry, where k - 2 > T),
    one tile of DENSE_BUDGET rows, and a few rows of no column (order -1 or
    >= C), sorted as a store is."""
    rng = np.random.default_rng(seed)
    n = 1_000
    edge = rng.integers(1, REC_LEN // T - 2, n) * T + rng.choice([0, T - 1], n)
    span = rng.integers(0, max(k - 1, 1), n)
    by_plus = rng.random(n) < 0.5
    start = np.where(by_plus, edge + k - 1 - span, edge)  # plus event: end - (k - 1) on the edge
    end = start + span
    # Long marked runs in two columns: one row every 3 tiles (k = 101: 99 positions marked).
    runs = np.arange(T, REC_LEN - T, 3 * T)
    crowd = rng.integers(40 * T, 41 * T, DENSE_BUDGET)  # one tile past any budget
    start = np.concatenate([start, runs, runs + T // 2, crowd])
    end = np.concatenate([end, runs + 1, runs + T // 2 + 1,
                          crowd + rng.integers(0, 3, DENSE_BUDGET)])
    order = np.concatenate([rng.integers(-1, C + 2, n), np.full(runs.size, 3),
                            np.full(runs.size, C - 7), rng.integers(0, C, DENSE_BUDGET)])
    keep = np.lexsort((end, start))
    start, end, order = start[keep], end[keep], order[keep]
    ok = (start >= 0) & (end <= REC_LEN)
    start, end, order = start[ok], end[ok], order[ok]
    return IntervalStore(record_names=["chr1"], record_lens=[REC_LEN], n_docs=C,
                         kind="conservation", rec_id=np.zeros(start.size, np.int32),
                         start=start, end=end, order=order)


def genes(rng, n, rec_len, lo, hi):
    """``n`` windows sorted by start, of lengths uniform in [lo, hi), with an
    empty window and two single positions."""
    lengths = rng.integers(lo, hi, n)
    lengths[[1, n // 2, n - 1]] = (0, 1, 1)
    starts = np.sort(rng.integers(0, rec_len - lengths.max(), n))
    return [(int(qs), int(qs + m)) for qs, m in zip(starts, lengths)]


def group_width(C: int) -> int:
    return -(-C // -(-C // fused_query.MAX_COLUMNS))


def tiles_of(wins, C: int, ragged: bool) -> int:
    """The tiles of one launch of ``wins`` (a ragged launch's units)."""
    T = fused_query.rows_tile(group_width(C))
    lengths = [qe - qs for qs, qe in wins]
    if ragged:
        return fused_query.ragged_units(sum(lengths), len(wins), T)
    return len(wins) * -(-max(lengths) // T)


def event_warps(G: int) -> int:
    """The fewest tiles a uniform launch over G columns splits: one for each
    event warp the card holds."""
    lo, hi = 1, 1 << 24
    while lo < hi:
        mid = (lo + hi) // 2
        lo, hi = (lo, mid) if fused_query.event_rows(G, mid) else (mid + 1, hi)
    return lo


def plain(e, wp, kw, offsets, step=4):
    """The plain version of a launch, ``step`` windows at a time."""
    n = wp.params.shape[0]
    return torch.cat([fused_query_rows_reference(
        e._d, wp.params[g0:g0 + step], wp.prefix[g0:g0 + step],
        **dict(kw, offsets=None if offsets is None else offsets.group(g0, min(g0 + step, n))))
        for g0 in range(0, n, step)])


def traced_launch(eng, wins, k, ragged, splits=True):
    """One call of fused_query_rows on ``wins`` in each length bucket that
    marks at k, under the profiler: every output equal to the plain
    version's; the launch splits its tiles or not, as ``splits`` says, and
    runs the apply kernels that says; returns the share of the tiles that
    took the event path."""
    lengths = [qe - qs for qs, qe in wins]
    L, C = max(lengths), eng.n_docs
    starts = [qs for qs, _ in wins]
    groups = -(-C // fused_query.MAX_COLUMNS)
    tiles = tiles_of(wins, C, ragged)
    assert (fused_query.event_rows(group_width(C), tiles, ragged) > 0) == splits, (C, tiles)
    buckets = eng._engines(k)
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        launches = []
        for e in buckets:
            wp = e._window_params("chr1", starts, L, k)
            offsets = ragged_table(starts, lengths, e._d.start.device)[1] if ragged else None
            kw = dict(k=k, L=L, C=C, n_docs=C, membership=False)
            launches.append((e, wp, kw, offsets,
                             fused_query_rows(e._d, wp.params, wp.prefix, offsets=offsets, **kw)))
        torch.cuda.synchronize()
    counts = profiling.counters()
    for e, wp, kw, offsets, got in launches:
        assert torch.equal(got, plain(e, wp, kw, offsets)), (C, k, ragged)
    applied = {evt.name for evt in prof.events() if "apply_kernel" in evt.name
               and str(evt.device_type).endswith("CUDA")}
    one = "ragged_apply_kernel" if ragged else "rows_apply_kernel"
    assert {any(n in a for a in applied) for n in ("event_apply", "dense_apply")} == {splits}
    assert any(one in a for a in applied) != splits
    real = sum(-(-m // fused_query.rows_tile(group_width(C))) for m in lengths) if ragged else tiles
    assert counts["memo.apply_tiles"] == len(buckets) * groups * real
    assert 0 <= counts["memo.event_tiles"] <= counts["memo.apply_tiles"]
    if not splits:
        assert counts["memo.event_tiles"] == 0
    return counts["memo.event_tiles"] / counts["memo.apply_tiles"]


def engine(store, device):
    return QueryEngine(store, device=device, stratify=True)


UNIFORM = [(7 + 1_000 * i, 100_007 + 1_000 * i) for i in range(16)]  # 6,256 tiles at C = 90


@pytest.mark.cuda
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("name", ["sparse", "dense"])
def test_chromosome_and_mhc_stores_equal_plain(cuda_device, stores, name, ragged):
    eng = engine(stores[name], cuda_device)
    wins = genes(np.random.default_rng(7), 48, REC_LEN, 20_000, 60_000) if ragged else UNIFORM
    share = traced_launch(eng, wins, 31, ragged)
    if name == "sparse":
        assert share >= 0.9  # the chromosome's tiles take the event path


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 31, 101])
@pytest.mark.parametrize("ragged", [False, True])
def test_one_launch_mixes_both_paths(cuda_device, stores, k, ragged):
    """Windows across the store's dense half and its sparse half, with as
    many tiles on each side as the card holds event warps."""
    eng = engine(stores["mixed"], cuda_device)
    half = REC_LEN // 2
    wins = ([(half - 58_000 + 1_000 * i, half + 42_000 + 1_000 * i) for i in range(16)]
            if not ragged else genes(np.random.default_rng(k), 48, REC_LEN, 20_000, 60_000))
    share = traced_launch(eng, wins, k, ragged)
    if k == 31 and not ragged:  # the dense half's tiles dense, the sparse half's events
        assert 0 < share < 1


@pytest.mark.cuda
def test_too_few_event_tiles_leave_them_to_the_dense_path(cuda_device, stores):
    """A launch that splits, over the mixed store's dense half but for a
    few tiles of its sparse half: fewer tiles listed for the event path than
    it has warps, so the dense kernel takes them too and none counts. One
    length bucket, whose tiles are counted here."""
    eng = QueryEngine(stores["mixed"], device=cuda_device, stratify=False)
    half = REC_LEN // 2
    wins = [(100 * i, half + 2_560 + 100 * i) for i in range(16)]
    e = eng._engines(31)[0]
    wp = e._window_params("chr1", [qs for qs, _ in wins], wins[0][1] - wins[0][0], 31)
    T = fused_query.rows_tile(90)
    L = wins[0][1] - wins[0][0]
    edges = torch.arange(0, L + T, T, device=cuda_device, dtype=torch.int64)
    rows = 0
    bound = fused_query.event_rows(90, tiles_of(wins, 90, False))
    for mlo, mhi, plo, phi, qs in wp.params.tolist():
        m = torch.searchsorted(e._d.start[mlo:mhi].to(torch.int64) - qs, edges)
        pl = torch.searchsorted(e._d.end_s[plo:phi].to(torch.int64) - (qs + 30), edges)
        rows += int(((m.diff() + pl.diff())[:-(-L // T)] <= bound).sum())
    assert 0 < rows < event_warps(90)  # some tiles listed for the event path, too few to run it
    assert traced_launch(eng, wins, 31, False) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("case", ["few_tiles", "few_columns"])
def test_launches_that_do_not_split_run_the_one_block_kernel(cuda_device, stores, case, ragged):
    """Fewer tiles than the card holds event warps, or C = 16, where the
    dense kernel fits fewer blocks an SM than the one-block kernel: the
    launch runs rows_apply_kernel (ragged_apply_kernel) alone, as unsplit."""
    if case == "few_tiles":
        eng = engine(stores["sparse"], cuda_device)
        wins = (genes(np.random.default_rng(5), 12, REC_LEN, 1_000, 20_000) if ragged
                else [(7, 100_007)])
    else:
        ms = synth(np.random.default_rng(16), REC_LEN, 15, 1100)
        eng = engine(store_from_ms([ms], ["chr1"], [REC_LEN], 16, "conservation"), cuda_device)
        wins = genes(np.random.default_rng(6), 48, REC_LEN, 20_000, 60_000) if ragged else UNIFORM
    assert traced_launch(eng, wins, 31, ragged, splits=False) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 31, 101])
@pytest.mark.parametrize("C", [90, 1000])
def test_tile_edges_carries_and_budget(cuda_device, C, k):
    """Events on a tile's first and last position, tiles with no event
    under a positive carry, one tile past any event budget, in one column
    group (C = 90, T = 256) or two (C = 1000: T = 64, the second from c0 =
    500), uniform and ragged, each window three times over so that the
    launch splits."""
    T = fused_query.rows_tile(group_width(C))
    eng = engine(edge_store(C, T, k, seed=C + k), cuda_device)
    uniform = [(0, 60_000), (T * 39, T * 39 + 60_000), (T * 40 + 5, T * 40 + 60_005)] * 3
    share = traced_launch(eng, uniform, k, False)
    assert share < 1  # the crowded tile took the dense path
    ragged = uniform + [(T * 40, T * 40), (T * 41 - 1, T * 41), (REC_LEN - 1, REC_LEN)]
    traced_launch(eng, ragged, k, True)


@pytest.mark.cuda
def test_untraced_launches_count_nothing(cuda_device, stores):
    eng = QueryEngine(stores["mixed"], device=cuda_device)
    profiling.reset_counters()
    batch = eng.conservation_batch("chr1", genes(np.random.default_rng(3), 50, REC_LEN, 100, 900),
                                   31)
    single = eng.conservation("chr1", 1_000, 90_000, 31)
    assert profiling.counters() == {}
    cpu = QueryEngine(stores["mixed"], device="cpu")
    np.testing.assert_array_equal(single, cpu.conservation("chr1", 1_000, 90_000, 31))
    assert len(batch) == 50
