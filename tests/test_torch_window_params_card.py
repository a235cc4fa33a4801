"""The window parameters on the card (``memo_tpu_torch.query.window``)
against the same function on CPU tensors, for every case of
``tests/window_cases.py``; the CPU's are held to memo_tpu's in
``test_torch_window_params.py``. Imports no JAX, so it runs where the card
is: ``MEMO_TPU_TEST_REAL_DEVICE=1 python -m pytest -m cuda
tests/test_torch_window_params_card.py``. Skips without a CUDA device.
Tolerance: exact (integers)."""

import pytest
import torch

from memo_tpu_torch.index.placement import place_store_and_layout
from memo_tpu_torch.index.store import IntervalStore
from memo_tpu_torch.query.window import window_params
from window_cases import CASES, HUGE_K, REC_LEN, WINDOWS, case_arrays


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the parameters on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_params_equal_the_cpus(cuda_device):
    """Every case, window set and k: the card's params, prefix and counts
    equal the CPU tensors'."""
    for name in CASES:
        store = IntervalStore(kind="conservation", **case_arrays(name))
        on_cpu = place_store_and_layout(store, "cpu", 8)
        on_card = place_store_and_layout(store, cuda_device, 8)
        for k in (1, 2, 31, 3 * REC_LEN, HUGE_K):
            for r in range(store.num_records):
                for L, starts in WINDOWS:
                    want = window_params(*on_cpu, r, starts, L, k)
                    got = window_params(*on_card, r, starts, L, k)
                    # params, prefix and counts: contiguous int32 views of one tensor
                    assert all(g.dtype == torch.int32 and g.is_contiguous() for g in got)
                    assert len({g.untyped_storage().data_ptr() for g in got}) == 1
                    for g, w in zip(got, want):
                        assert g.device.type == "cuda" and torch.equal(g.cpu(), w), (name, k, r, L)
