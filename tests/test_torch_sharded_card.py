"""ShardedQuery (position and interval) on the card from a loaded index: the
columns streamed from a stored and a deflated ``.npz`` to the card, each
window's rows found and gathered there, every output back in one pinned
copy, against the same store's ShardedQuery on the CPU;
``test_torch_sharded_load.py`` holds the CPU to memo_tpu. Imports no JAX,
so it runs where the card is: ``MEMO_TPU_TEST_REAL_DEVICE=1 python -m
pytest -m cuda tests/test_torch_sharded_card.py``. Skips without a CUDA
device. Tolerance: exact (integers)."""

import numpy as np
import pytest
import torch

from memo_tpu_torch.index.builder import store_from_ms
from memo_tpu_torch.index.store import COLUMNS, IntervalStore
from memo_tpu_torch.parallel import ShardedQuery
from memo_tpu_torch.query import engine as engine_mod

KS = (3, 31, 51)
LENS = {"dense": 4096, "sparse": 4096, "empty": 80, "r3": 1001}
WINDOWS = [("dense", 0, 4096), ("sparse", 0, 4096), ("sparse", 64, 2000), ("dense", 8, 1037),
           ("r3", 990, 1001), ("dense", 4000, 4096), ("empty", 3, 40), ("r3", 0, 1),
           ("dense", 100, 101), ("r3", 17, 1000)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the placement, search and gather on the card")
    return torch.device("cuda")


def _store(kind: str) -> IntervalStore:
    rng = np.random.default_rng(31)
    dense = rng.integers(0, 60, size=(4096, 7)).astype(np.int32)
    sparse = np.zeros((4096, 7), np.int32)
    sparse[::97] = 3
    ms = [dense, sparse, np.zeros((0, 7), np.int32),
          rng.integers(0, 40, size=(1001, 7)).astype(np.int32)]
    return store_from_ms(ms, list(LENS), list(LENS.values()), 8, kind)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["conservation", "membership"])
def test_card_equals_cpu_from_a_loaded_store(cuda_device, tmp_path, monkeypatch, kind):
    """Both strategies, stored and deflated files: the card's outputs ==
    the CPU's window for window, no column read on the host, and each call
    makes one copy back (``engine._copy_back``, pinned) and one wait."""
    copies = []
    real_copy_back = engine_mod._copy_back

    def copy_back(t):
        host, ready = real_copy_back(t)
        copies.append((t.device.type, host.is_pinned(), ready is not None))
        return host, ready

    monkeypatch.setattr(engine_mod, "_copy_back", copy_back)
    store = _store(kind)
    mode = kind
    on_cpu = {s: ShardedQuery(store, "cpu", strategy=s) for s in ("position", "interval")}
    for compressed in (False, True):
        path = tmp_path / f"idx_{compressed}.npz"
        store.save(path, compressed=compressed)
        for strategy, cpu_sq in on_cpu.items():
            loaded = IntervalStore.load(path)
            sq = ShardedQuery(loaded, cuda_device, strategy=strategy)
            assert sq._start.device.type == "cuda"
            for k in KS:
                copies.clear()
                got = getattr(sq, mode)(WINDOWS, k)
                assert copies == [("cuda", True, True)]  # one pinned copy, one event
                want = getattr(cpu_sq, mode)(WINDOWS, k)
                for w, g, c in zip(WINDOWS, got, want):
                    assert g.dtype == c.dtype
                    np.testing.assert_array_equal(g, c, err_msg=f"{strategy} {w} k={k}")
            assert loaded.file_columns()[1] == list(COLUMNS)
