"""Wide stores and large batches on the card (``cuda`` tests; they skip
where no CUDA device exists). Imports no JAX: the CPU's outputs here are
the port's own plain version, which ``test_torch_wide_stores.py`` and
``test_torch_many_windows.py`` hold to memo_tpu.

- Both kernels at C = 1000 through the engine, in two column groups of
  500, conservation and membership, one window and a batch, whole and
  stratified: equal to the kernels' plain version over all 1000 columns on
  the same card tensors, and to the CPU engine's output.
- 65,537 windows of 32 positions of the headline store (2 Mbp, 16 genomes)
  through ``conservation_batch`` with each kernel: two window groups (the
  first of 65,535), equal to the CPU engine's output.
- The window kernel's scan at 12,289 columns is ``window_cases``'
  ``non_monotone_wide``, held to the CPU in
  ``test_torch_window_params_card.py``.

Tolerance: exact (integers)."""

import numpy as np
import pytest
import torch

from memo_tpu_torch import QueryEngine
from memo_tpu_torch.index.builder import store_from_ms
from memo_tpu_torch.ops.fused_query import MAX_WINDOWS, fused_query_rows, fused_query_rows_reference
from memo_tpu_torch.ops.fused_query_v2 import fused_query_v2_rows
from window_cases import lipschitz

REC_LEN = 900
C = 1000
WINDOWS = [(0, 300), (250, 900), (899, 900), (10, 11)]
WRAPPERS = {"v1": fused_query_rows, "v2": fused_query_v2_rows}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run there")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def wide():
    """Half short and half long MS values over two records at C = 1000:
    bucket 0 holds most rows of the stratified engine."""
    rng = np.random.default_rng(C)
    mix = np.where(rng.random((REC_LEN, C - 1)) < 0.5, rng.integers(0, 40, (REC_LEN, C - 1)),
                   rng.integers(100, 3000, (REC_LEN, C - 1))).astype(np.int32)
    return {kind: store_from_ms([lipschitz(mix), lipschitz(mix[:400])], ["chrA", "chrB"],
                                [REC_LEN, 400], C, kind)
            for kind in ("conservation", "membership")}


@pytest.mark.cuda
@pytest.mark.parametrize("stratify", [False, True], ids=["whole", "stratified"])
@pytest.mark.parametrize("version", ["v1", "v2"])
def test_c1000_equals_plain_and_cpu(cuda_device, wide, version, stratify):
    """Each mode, one window and the batch: two launches a chunk or bucket,
    the card's output equal to the plain version over all columns of each
    engine that can mark, and to the CPU engine's."""
    run = WRAPPERS[version]
    for kind, store in wide.items():
        membership = kind == "membership"
        on = {dev: QueryEngine(store, device=dev, kernel_version=version, stratify=stratify,
                               device_output=True) for dev in (cuda_device, "cpu")}
        for k in (31, 51):
            before = run.launches
            got = getattr(on[cuda_device], kind)("chrA", 0, REC_LEN, k)
            torch.cuda.synchronize()
            engines = ([e for lb, e in on[cuda_device]._children if lb < k - 1] if stratify
                       else [on[cuda_device]])
            assert run.launches == before + 2 * len(engines)
            assert torch.equal(got.cpu(), getattr(on["cpu"], kind)("chrA", 0, REC_LEN, k))
            batch = getattr(on[cuda_device], f"{kind}_batch")("chrA", WINDOWS, k)
            want = getattr(on["cpu"], f"{kind}_batch")("chrA", WINDOWS, k)
            assert all(torch.equal(g.cpu(), w) for g, w in zip(batch, want)), (kind, k)
            L = max(qe - qs for qs, qe in WINDOWS)
            for eng in engines:
                wp = eng._window_params("chrA", [qs for qs, _ in WINDOWS], L, k)
                kw = dict(k=k, L=L, C=C, n_docs=C, membership=membership)
                plain = fused_query_rows_reference(eng._d, wp.params, wp.prefix, **kw)
                assert torch.equal(eng._run_kernel(wp, k, L, membership), plain), (kind, k)


@pytest.mark.cuda
@pytest.mark.parametrize("version", ["v1", "v2"])
def test_more_windows_than_a_launch_takes(cuda_device, version):
    """65,537 windows of the headline store in one conservation_batch: two
    launches, the output equal to the CPU engine's."""
    import chip_smoke

    store = chip_smoke.build_store(np.random.default_rng(chip_smoke.SEED))
    windows = [(i * 31, i * 31 + 32) for i in range(MAX_WINDOWS + 2)]
    run = WRAPPERS[version]
    card = QueryEngine(store, device=cuda_device, kernel_version=version, stratify=False,
                       device_output=True)
    before = run.launches
    got = torch.stack(card.conservation_batch("chr1", windows, 31)).cpu()
    assert run.launches == before + 2
    cpu = QueryEngine(store, device="cpu", kernel_version=version, stratify=False,
                      device_output=True)
    want = torch.stack(cpu.conservation_batch("chr1", windows, 31))
    assert got.shape == (MAX_WINDOWS + 2, 32) and torch.equal(got, want)
    assert card.last_stats == cpu.last_stats
