"""Ragged launches on the card (``cuda`` tests; they skip where no CUDA
device exists): a batch whose windows differ in length launches each window
over its own tiles and writes one packed output. Imports no JAX: the CPU
holds the plain version to memo_tpu (``test_torch_fused_rows.py``,
``test_torch_batch.py``); here each kernel is held to it on the card.

- 1,400 windows of the headline store (2 Mbp, 16 genomes), log-normal
  lengths (median 220, up to 50 times that, an empty one and single
  positions), in one launch of each kernel: equal to the plain version and
  to the uniform launch at the longest length cut to each window's length;
  the same through ``conservation_batch``, whose answers are views of one
  packed array.
- Membership at C = 90, each kernel.
- C = 1000 (two column groups), both kinds, each kernel.
- The uniform path: a batch of equal lengths and a single-window query take
  no table and equal the plain version.

Tolerance: exact (integers)."""

import numpy as np
import pytest
import torch

from memo_tpu_torch import QueryEngine
from memo_tpu_torch.index.builder import store_from_ms
from memo_tpu_torch.ops import fused_query, fused_query_v2
from memo_tpu_torch.ops.fused_query import fused_query_rows, fused_query_rows_reference
from memo_tpu_torch.ops.fused_query_v2 import fused_query_v2_rows
from memo_tpu_torch.query.window import ragged_table
from window_cases import lipschitz

WRAPPERS = {"v1": fused_query_rows, "v2": fused_query_v2_rows}
K = 31


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run there")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def headline():
    import chip_smoke

    return chip_smoke.build_store(np.random.default_rng(chip_smoke.SEED))


def gene_windows(rng, n: int, rec_len: int, median: int) -> list[tuple[int, int]]:
    """``n`` windows sorted by start, log-normal lengths of ``median``, at
    most 50 times it, with an empty window and two single positions."""
    lengths = np.clip(rng.lognormal(np.log(median), 1.0, n), 1, 50 * median).astype(np.int64)
    lengths[[1, n // 2, n - 1]] = (0, 1, 1)
    starts = np.sort(rng.integers(0, rec_len - lengths.max(), n))
    return [(int(qs), int(qs + m)) for qs, m in zip(starts, lengths)]


def ragged_equals_plain(eng, record, wins, version, membership):
    """One ragged launch of ``version`` on ``wins``: its packed output
    against the plain version and against the uniform launch cut."""
    lengths = [qe - qs for qs, qe in wins]
    L, C = max(lengths), eng.n_docs
    starts = [qs for qs, _ in wins]
    wp = eng._window_params(record, starts, L, K)
    _, offsets = ragged_table(starts, lengths, eng._d.start.device)
    kw = dict(k=K, L=L, C=C, n_docs=C, membership=membership)
    run = WRAPPERS[version]
    before = run.launches
    got = run(eng._d, wp.params, wp.prefix, offsets=offsets, **kw)
    torch.cuda.synchronize()
    groups = -(-C // (fused_query if version == "v1" else fused_query_v2).MAX_COLUMNS)
    assert run.launches == before + groups
    assert got.shape == ((sum(lengths), C) if membership else (sum(lengths),))
    plain = fused_query_rows_reference(eng._d, wp.params, wp.prefix, offsets=offsets, **kw)
    assert torch.equal(got, plain), (version, membership, C)
    uniform = run(eng._d, wp.params, wp.prefix, **kw)
    cut = uniform[torch.arange(L, device=got.device) < offsets.device.diff()[:, None]]
    assert torch.equal(got, cut), (version, membership, C)


@pytest.mark.cuda
@pytest.mark.parametrize("version", ["v1", "v2"])
def test_gene_batch_equals_plain(cuda_device, headline, version):
    wins = gene_windows(np.random.default_rng(1400), 1400, 2_000_000, 220)
    eng = QueryEngine(headline, device=cuda_device, kernel_version=version, stratify=False)
    ragged_equals_plain(eng, "chr1", wins, version, False)
    outs = eng.conservation_batch("chr1", wins, K)
    assert all(o.base is outs[0].base for o in outs)
    assert outs[0].base.shape == (sum(qe - qs for qs, qe in wins),)
    cpu = QueryEngine(headline, device="cpu", kernel_version=version, stratify=False)
    picks = [0, 1, 2, 700, 1399] + [int(i) for i in np.argsort([qe - qs for qs, qe in wins])[-3:]]
    for i, want in zip(picks, cpu.conservation_batch("chr1", [wins[i] for i in picks], K)):
        np.testing.assert_array_equal(outs[i], want, err_msg=str(wins[i]))


@pytest.mark.cuda
@pytest.mark.parametrize("version", ["v1", "v2"])
def test_membership_c90_equals_plain(cuda_device, version):
    import chip_smoke

    rec_len = 60_000
    ms = chip_smoke.synth_ms(np.random.default_rng(90), rec_len, 89, K)
    store = store_from_ms([ms], ["chr1"], [rec_len], 90, "membership")
    eng = QueryEngine(store, device=cuda_device, kernel_version=version, stratify=False)
    wins = gene_windows(np.random.default_rng(91), 200, rec_len, 150)
    ragged_equals_plain(eng, "chr1", wins, version, True)


@pytest.mark.cuda
@pytest.mark.parametrize("version", ["v1", "v2"])
def test_c1000_column_groups_equal_plain(cuda_device, version):
    rng = np.random.default_rng(1000)
    mix = np.where(rng.random((900, 999)) < 0.5, rng.integers(0, 40, (900, 999)),
                   rng.integers(100, 3000, (900, 999))).astype(np.int32)
    wins = [(0, 300), (250, 900), (899, 900), (10, 11), (400, 400), (100, 650), (5, 105)]
    for kind in ("conservation", "membership"):
        store = store_from_ms([lipschitz(mix)], ["chrA"], [900], 1000, kind)
        eng = QueryEngine(store, device=cuda_device, kernel_version=version, stratify=False)
        ragged_equals_plain(eng, "chrA", wins, version, kind == "membership")


@pytest.mark.cuda
@pytest.mark.parametrize("version", ["v1", "v2"])
def test_uniform_path_takes_no_table(cuda_device, headline, version, monkeypatch):
    """A batch of equal lengths and a single-window query launch without
    offsets, [Q, L] as before, equal to the plain version."""
    module = fused_query if version == "v1" else fused_query_v2
    tables = []

    def logged(*args, _real=module._launch_group, **kw):
        tables.append(kw["offsets"])
        return _real(*args, **kw)

    monkeypatch.setattr(module, "_launch_group", logged)
    eng = QueryEngine(headline, device=cuda_device, kernel_version=version, stratify=False,
                      device_output=True)
    wins = [(qs, qs + 3000) for qs in range(0, 1_990_000, 99_500)]
    batch = eng.conservation_batch("chr1", wins, K)
    single = eng.conservation("chr1", 1_000_000, 1_400_000, K)
    assert len(tables) == 2 and tables == [None, None]
    wp = eng._window_params("chr1", [qs for qs, _ in wins], 3000, K)
    plain = fused_query_rows_reference(eng._d, wp.params, wp.prefix, k=K, L=3000, C=16,
                                       n_docs=16, membership=False)
    assert torch.equal(torch.stack(batch), plain)
    wp = eng._window_params("chr1", [1_000_000], 400_000, K)
    plain = fused_query_rows_reference(eng._d, wp.params, wp.prefix, k=K, L=400_000, C=16,
                                       n_docs=16, membership=False)
    assert torch.equal(single, plain[0])
