"""A saved store's columns streamed to the card (``index/npz.py`` through
``index/placement.upload_columns``: pinned staging buffers, non-blocking
copies on each worker's stream) against the upload of the same store built
in memory, and ResidentShardedQuery set up from the file (its slab rows
streamed, its bounds and check found without the host columns) against its
set-up from the store in memory; ``test_torch_store_load.py`` and
``test_torch_resident_load.py`` hold the CPU paths to memo_tpu.
Imports no JAX, so it runs where the card is: ``MEMO_TPU_TEST_REAL_DEVICE=1
python -m pytest -m cuda tests/test_torch_store_load_card.py``. Skips
without a CUDA device. Tolerance: exact (integers)."""

import zipfile

import numpy as np
import pytest
import torch

from memo_tpu_torch.index import npz as npz_mod
from memo_tpu_torch.index.placement import upload_columns
from memo_tpu_torch.index.store import COLUMNS, IntervalStore
from memo_tpu_torch.parallel import ResidentShardedQuery
from window_cases import case_arrays


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the streamed upload to the card")
    return torch.device("cuda")


def _rings(monkeypatch) -> list:
    """Every staging ring the uploads below make."""
    made, real = [], npz_mod._Ring.__init__

    def init(self, *args, **kwargs):
        real(self, *args, **kwargs)
        made.append(self)

    monkeypatch.setattr(npz_mod._Ring, "__init__", init)
    return made


def _big_store() -> IntervalStore:
    """Two million rows: many 1 MB chunks per column, buffers reused."""
    rng = np.random.default_rng(11)
    n = 2_000_000
    start = np.sort(rng.integers(0, 1 << 40, n))
    return IntervalStore(record_names=["chr0"], record_lens=[1 << 41], n_docs=90,
                         kind="conservation", rec_id=np.zeros(n, np.int32), start=start,
                         end=start + rng.integers(0, 5000, n), order=rng.integers(0, 90, n))


@pytest.mark.cuda
@pytest.mark.parametrize("compressed", [False, True])
def test_streamed_columns_equal_the_in_memory_upload(cuda_device, tmp_path, monkeypatch,
                                                     compressed):
    rings = _rings(monkeypatch)
    stores = {"ms_records": IntervalStore(kind="conservation", **case_arrays("ms_records")),
              "empty_store": IntervalStore(kind="conservation", **case_arrays("empty_store")),
              "big": _big_store()}
    for name, store in stores.items():
        path = tmp_path / f"{name}.npz"
        store.save(path, compressed=compressed)
        monkeypatch.setattr(npz_mod, "CHUNK_BYTES", 1 << 20 if name == "big" else 4096)
        got = upload_columns(IntervalStore.load(path), cuda_device)
        want = upload_columns(store, cuda_device)
        for g, w in zip(got, want):
            assert g.device.type == "cuda" and g.dtype == w.dtype and torch.equal(g, w), name
    assert rings and all(b.is_pinned() for ring in rings for b in ring.bufs)
    assert all(ring.stream is not None for ring in rings)
    assert sum(len(ring.copy_events) for ring in rings) > 3 * 16  # the big store's chunks


@pytest.mark.cuda
def test_a_corrupt_member_raises_on_the_card(cuda_device, tmp_path, monkeypatch):
    path = tmp_path / "idx.npz"
    IntervalStore(kind="conservation", **case_arrays("ms_records")).save(path, compressed=False)
    data = bytearray(path.read_bytes())
    with zipfile.ZipFile(path) as zf:
        offset = zf.getinfo("end.npy").header_offset
    data[data.find(b"\x93NUMPY", offset) + 200] ^= 4  # a bit of end's data
    path.write_bytes(bytes(data))
    monkeypatch.setattr(npz_mod, "CHUNK_BYTES", 4096)
    with pytest.raises(zipfile.BadZipFile):
        upload_columns(IntervalStore.load(path), cuda_device)


def _resident_store() -> IntervalStore:
    """Two million rows over a record of 4 Mbp at n = 90, some too long to
    mark at k <= 1024 (the resident placement drops them)."""
    rng = np.random.default_rng(12)
    n, length = 2_000_000, 4_000_000
    start = np.sort(rng.integers(0, length, n))
    return IntervalStore(record_names=["chr0"], record_lens=[length], n_docs=90,
                         kind="conservation", rec_id=np.zeros(n, np.int32), start=start,
                         end=start + rng.integers(0, 1500, n), order=rng.integers(1, 90, n))


@pytest.mark.cuda
@pytest.mark.parametrize("compressed", [False, True], ids=["stored", "deflated"])
def test_resident_from_the_file_equals_the_in_memory_placement(cuda_device, tmp_path,
                                                                monkeypatch, compressed):
    """Set up from the file in 1 MB chunks (pinned rings), with numpy's
    member reader refusing the columns: the same placed rows as the set-up
    from the store in memory, no column read on the host, and the same
    whole-record conservation at k = 31, brought to the host in one copy."""
    rings = _rings(monkeypatch)
    store = _resident_store()
    path = tmp_path / "idx.npz"
    store.save(path, compressed=compressed)
    monkeypatch.setattr(npz_mod, "CHUNK_BYTES", 1 << 20)
    real = np.lib.format.read_array

    def small_only(*args, **kwargs):
        arr = real(*args, **kwargs)
        assert arr.size <= 2, f"numpy's reader read an array of {arr.size} elements"
        return arr

    monkeypatch.setattr(np.lib.format, "read_array", small_only)
    loaded = IntervalStore.load(path)
    got = ResidentShardedQuery(loaded, cuda_device, k_max=1024)
    want = ResidentShardedQuery(store, cuda_device, k_max=1024)
    assert loaded.file_columns()[1] == list(COLUMNS)
    assert got.local_rows == want.local_rows > 0
    for mine, theirs in zip(got._placed(), want._placed(), strict=True):
        for a, b in zip(mine._d, theirs._d):
            assert a.device.type == "cuda" and torch.equal(a, b)
    assert rings and all(b.is_pinned() for ring in rings for b in ring.bufs)
    windows = [(0, 4_000_000), (1_234_567, 1_300_000), (3_999_999, 4_000_000)]
    for g, w in zip(got.conservation_windows(windows, 31), want.conservation_windows(windows, 31)):
        assert isinstance(g, np.ndarray) and np.array_equal(g, w)
    assert loaded.file_columns()[1] == list(COLUMNS)
