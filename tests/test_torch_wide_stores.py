"""Stores wider than one kernel launch takes, on the CPU.

One launch of v1 takes at most ``fused_query.MAX_COLUMNS`` = 854 columns and
one of v2 ``fused_query_v2.MAX_COLUMNS`` = 819 (their shared memory); memo_tpu
takes any width. The wrappers split a wider store into column groups of
equal width (``fused_query.launch_groups``), each launch over its group
[c0, c0 + G): membership groups fill their columns of the one output,
conservation groups are min-combined into it. On the CPU each launch runs
the kernels' plain version over its group, so the grouping and the combine
run here as on the card.

- C = 855 and 1000 with v1 and C = 820 with v2, conservation and
  membership, through the single-window, chunked, stratified, batch (whole
  and stratified) and resident paths at k = 31 and 51: every launch's group
  fits the kernel, the groups cover the store's columns in order, the
  outputs equal memo_tpu's numpy engine and ``last_stats`` equals
  memo_tpu's (``memo_stats.py``).
- The group width lowered to 5 at C = 16 and 90: the combine over many
  groups, on every path, with both kernels' wrappers; at C = 90 also
  against memo_tpu's ``jax`` backend on the CPU.
- A group's launch: membership columns and the conservation minimum over
  the groups equal the plain version over the whole width; the groups of
  a call cover its windows and columns in order, as views of its tensors;
  one launch's width limits stay where they were.

Tolerance: exact (integers)."""

import numpy as np
import pytest
import torch
from test_torch_fused_rows import random_store
from test_torch_query_sync import PATHS, REC_LEN, _make, _query, _want
from test_torch_whole_windows import _memo_tpu_stats

from memo_tpu.index.builder import store_from_ms
from memo_tpu.query.engine import QueryEngine as JaxEngine
from memo_tpu_torch.index.store import IntervalStore
from memo_tpu_torch.ops import fused_query, fused_query_v2
from memo_tpu_torch.ops.fused_query import (
    fused_query_rows_reference,
    kernel_constants,
    launch_groups,
    rows_tile,
)
from memo_tpu_torch.ops.fused_query_v2 import v2_constants
from memo_tpu_torch.parallel import ResidentShardedQuery
from memo_tpu_torch.query.engine import QueryEngine
from window_cases import lipschitz

WRAPPERS = {"v1": "fused_query_rows", "v2": "fused_query_v2_rows"}
MODULES = {"v1": fused_query, "v2": fused_query_v2}
WIDE = ((855, "v1"), (1000, "v1"), (820, "v2"))  # one past each kernel's widest, and 1000


def mixed_store(C: int, kind: str) -> IntervalStore:
    """memo_tpu's store of half short and half long MS values over chrA
    (REC_LEN) and chrB (400) at width C, as ``test_torch_query_sync.mixed``
    builds it at C = 9: bucket 0 holds most rows, the longer buckets some."""
    rng = np.random.default_rng(C)
    mix = np.where(rng.random((REC_LEN, C - 1)) < 0.5, rng.integers(0, 40, (REC_LEN, C - 1)),
                   rng.integers(100, 3000, (REC_LEN, C - 1))).astype(np.int32)
    ref = store_from_ms([lipschitz(mix), lipschitz(mix[:400])], ["chrA", "chrB"],
                        [REC_LEN, 400], C, kind)
    return IntervalStore(record_names=ref.record_names, record_lens=ref.record_lens, n_docs=C,
                         kind=kind, rec_id=ref.rec_id, start=ref.start, end=ref.end,
                         order=ref.order)


_STORES: dict = {}


def stores(C: int, kind: str) -> IntervalStore:
    if (C, kind) not in _STORES:
        _STORES[(C, kind)] = mixed_store(C, kind)
    return _STORES[(C, kind)]


@pytest.fixture
def launches(monkeypatch):
    """Every kernel launch the engine makes, in order: (wrapper, Q, c0, G, C)."""
    log = []
    for version, module in MODULES.items():
        def logged(placed, params, prefix, out, n_rows, *, _real=module._launch_group,
                   _name=WRAPPERS[version], **kw):
            log.append((_name, params.shape[0], kw["c0"], kw["G"], kw["C"]))
            return _real(placed, params, prefix, out, n_rows, **kw)

        monkeypatch.setattr(module, "_launch_group", logged)
    return log


def check_groups(log: list, version: str, widest: int, C: int) -> int:
    """Each launch ran ``version``'s wrapper over at most ``widest``
    columns, and the launches' groups cover [0, C) in order, run after run.
    Returns the number of groups of a run."""
    assert log and all(entry[0] == WRAPPERS[version] for entry in log), log
    expect, groups = 0, set()
    for _, _, c0, G, width in log:
        assert width == C and 1 <= G <= widest and c0 == expect, log
        expect = (c0 + G) % C
        groups.add((c0, G))
    assert expect == 0, log
    return len(groups)


def _paths_equal_memo_tpu(C, version, path, kind, ks, widest, launches, monkeypatch):
    monkeypatch.setenv("MEMO_TPU_PALLAS_KERNEL", version)
    store = stores(C, kind)
    holder, oracle = _make(path, store), JaxEngine(store, backend="numpy")
    engine = holder.engine if isinstance(holder, ResidentShardedQuery) else holder
    for k in ks:
        launches.clear()
        got = _query(path, holder, kind, k)
        groups = check_groups(launches, version, widest, C)
        assert groups == -(-C // widest), launches  # as few groups as fit
        for g, w in zip(got, _want(path, oracle, kind, k)):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{path} C={C} k={k}")
        want = _memo_tpu_stats(path, store, k, None, kind == "membership")
        assert engine.last_stats.as_dict() == want, (k, want)


@pytest.mark.parametrize("kind", ["conservation", "membership"])
@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("C,version", WIDE, ids=[f"C{C}-{v}" for C, v in WIDE])
def test_wide_store_equals_memo_tpu(launches, monkeypatch, C, version, path, kind):
    """A store one column wider than a launch takes (and C = 1000) answers
    on every path, in column groups, as memo_tpu's numpy engine does."""
    widest = (fused_query if version == "v1" else fused_query_v2).MAX_COLUMNS
    assert C > widest
    _paths_equal_memo_tpu(C, version, path, kind, (31, 51), widest, launches, monkeypatch)


@pytest.mark.parametrize("kind", ["conservation", "membership"])
@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("version", ["v1", "v2"])
@pytest.mark.parametrize("C", [16, 90])
def test_lowered_group_width_equals_memo_tpu(launches, monkeypatch, C, version, path, kind):
    """With a launch's width lowered to 5 columns, C = 16 and 90 run in 4
    and 18 groups on every path, with outputs and ``last_stats`` equal to
    memo_tpu's."""
    monkeypatch.setattr(fused_query, "MAX_COLUMNS", 5)
    monkeypatch.setattr(fused_query_v2, "MAX_COLUMNS", 5)
    _paths_equal_memo_tpu(C, version, path, kind, (31, 51, 200), 5, launches, monkeypatch)


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_column_groups_match_jax_backend(launches, monkeypatch, version):
    """Groups of 5 of a 90-column store against memo_tpu's ``jax`` backend
    on the CPU, both modes, one window and a batch."""
    monkeypatch.setattr(fused_query, "MAX_COLUMNS", 5)
    monkeypatch.setattr(fused_query_v2, "MAX_COLUMNS", 5)
    for kind in ("conservation", "membership"):
        store = random_store(np.random.default_rng(90), 90, kind, rec_len=600)
        eng = QueryEngine(store, device="cpu", kernel_version=version, stratify=False)
        jax_eng = JaxEngine(store, backend="jax", stratify=False)
        wins = [(0, 600), (550, 600), (7, 8)]
        launches.clear()
        got = [getattr(eng, kind)("chr0", 0, 600, 31),
               *getattr(eng, f"{kind}_batch")("chr0", wins, 31)]
        assert check_groups(launches, version, 5, 90) == 18
        for g, (qs, qe) in zip(got, [(0, 600), *wins]):
            np.testing.assert_array_equal(g, getattr(jax_eng, kind)("chr0", qs, qe, 31))


def test_narrow_store_launches_once_with_the_whole_width(launches):
    """A store that fits one launch is launched as before the groups: one
    launch per chunk or batch, over all of its windows and columns."""
    store = random_store(np.random.default_rng(5), 90, rec_len=2000)
    eng = QueryEngine(store, device="cpu", stratify=False)
    eng.conservation("chr0", 0, 2000, 31)
    eng.membership_batch("chr0", [(0, 300), (5, 900)], 31)
    assert launches == [("fused_query_rows", 1, 0, 90, 90), ("fused_query_rows", 2, 0, 90, 90)]


@pytest.mark.parametrize("version", ["v1", "v2"])
@pytest.mark.parametrize("C", [33, 160])
def test_groups_combine_to_the_whole_width(C, version):
    """Each kernel module's launch (its plain version on the CPU) over
    groups of a store's columns into one output: membership groups fill
    their columns alone, conservation groups after the first min-combine,
    and the output equals the plain version over all C columns; a group's
    conservation alone is c0 plus its first marked column, or n_docs."""
    store = random_store(np.random.default_rng(C), C, rec_len=1500)
    eng = QueryEngine(store, device="cpu", stratify=False)
    launch = MODULES[version]._launch_group
    wins = [(0, 700), (1450, 1500), (100, 101)]
    L = max(qe - qs for qs, qe in wins)
    for k in (2, 31):
        wp = eng._window_params("chr0", [qs for qs, _ in wins], L, k)
        kw = dict(k=k, L=L, C=C, n_docs=C)
        marks = fused_query_rows_reference(eng._d, wp.params, wp.prefix, membership=True,
                                           **kw) == 0
        for membership in (False, True):
            whole = fused_query_rows_reference(eng._d, wp.params, wp.prefix,
                                               membership=membership, **kw)
            out = torch.full_like(whole, -1)
            for c0, G in ((0, 7), (7, C - 20), (C - 13, 13)):
                if not membership:
                    marked = marks[..., c0:c0 + G]
                    first = torch.where(marked.any(-1), marked.int().argmax(-1) + c0, C)
                    alone = fused_query_rows_reference(eng._d, wp.params, wp.prefix, c0=c0, G=G,
                                                       membership=False, **kw)
                    assert torch.equal(alone, first.to(alone.dtype)), (k, c0, G)
                launch(eng._d, wp.params, wp.prefix, out, None, c0=c0, G=G,
                       membership=membership, **kw)
                if membership:
                    assert (out[..., c0 + G:] == -1).all(), (k, c0, G)
            assert torch.equal(out, whole), (k, membership)


GROUPINGS = [(10, 16, 5, 3), (7, 90, 90, 7), (1, 1000, 854, 65_535), (5, 820, 819, 2)]


@pytest.mark.parametrize("Q,C,widest,max_windows", GROUPINGS,
                         ids=[f"Q{q}-C{c}-w{w}-m{m}" for q, c, w, m in GROUPINGS])
def test_launch_groups_cover_the_call(monkeypatch, Q, C, widest, max_windows):
    """A call's launches: window groups of at most the limit, in order,
    each over as few column groups of equal width as fit, in order; each
    launch's parameters, prefix and output are views of the call's (no
    copy), and the output returned is the one they wrote."""
    monkeypatch.setattr(fused_query, "MAX_WINDOWS", max_windows)
    params = torch.zeros(Q, 5, dtype=torch.int32)
    prefix = torch.zeros(Q, C, dtype=torch.int32)
    seen = []

    def launch(placed, p, x, out, n_rows, **kw):
        seen.append((p.data_ptr(), x.data_ptr(), out.data_ptr(), p.shape[0], kw["c0"], kw["G"]))
        out.fill_(1)

    for membership in (False, True):
        seen.clear()
        out = launch_groups(launch, (), params, prefix, None, widest=widest, k=31, L=4, C=C,
                            n_docs=C, membership=membership)
        assert out.shape == ((Q, 4, C) if membership else (Q, 4)) and (out == 1).all()
        n_groups = -(-C // widest)
        G = -(-C // n_groups)
        want = [(g0, min(max_windows, Q - g0), c0, min(G, C - c0))
                for g0 in range(0, Q, max_windows) for c0 in range(0, C, G)]
        row = out[0].numel() * out.element_size()
        assert seen == [(params.data_ptr() + g0 * 20, prefix.data_ptr() + g0 * C * 4,
                         out.data_ptr() + g0 * row, q, c0, g) for g0, q, c0, g in want]
        assert len({g for *_, g in seen}) <= 2 and max(g for *_, g in seen) <= widest


def test_one_launch_keeps_its_width_limits():
    """What one launch takes is unchanged: the module limits are the widths
    at which the tile functions stop, and those still refuse past them."""
    assert fused_query.MAX_COLUMNS == 854 and fused_query_v2.MAX_COLUMNS == 819
    assert kernel_constants(854) == 64 and rows_tile(854) == 64
    assert v2_constants(819)[0] == 64
    for fn, widest in ((kernel_constants, 854), (rows_tile, 854), (v2_constants, 819)):
        with pytest.raises(ValueError, match=f"at most {widest} columns"):
            fn(widest + 1)


def test_plain_version_takes_any_width():
    """The plain version has no shared memory to fit: at C = 1000 over all
    columns it equals memo_tpu's numpy engine."""
    store = random_store(np.random.default_rng(1000), 1000, rec_len=400, per_pos=2)
    eng = QueryEngine(store, device="cpu", stratify=False)
    oracle = JaxEngine(store, backend="numpy")
    wins = [(0, 400), (390, 400)]
    wp = eng._window_params("chr0", [0, 390], 400, 31)
    for membership in (False, True):
        got = fused_query_rows_reference(eng._d, wp.params, wp.prefix, k=31, L=400, C=1000,
                                         n_docs=1000, membership=membership)
        for i, (qs, qe) in enumerate(wins):
            want = oracle._query("chr0", qs, qe, 31, membership)
            np.testing.assert_array_equal(got[i, : qe - qs].numpy(), want)
