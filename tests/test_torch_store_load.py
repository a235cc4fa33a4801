"""The port's index load (``memo_tpu_torch.index.store.IntervalStore.load``
over ``index/npz.py``'s member reader) against memo_tpu's ``np.load``-based
load, and the columns streamed from the file by ``upload_columns`` against
the upload of the same store built in memory, on CPU tensors (the same
chunks and inflates as on the card, with plain staging buffers). Tolerance:
exact (integers and bytes)."""

import hashlib
import zipfile
import zlib

import numpy as np
import pytest
import torch

from memo_tpu import cli as ref_cli
from memo_tpu.index.store import IntervalStore as RefStore
from memo_tpu.query.engine import QueryEngine as JaxEngine
from memo_tpu_torch import cli
from memo_tpu_torch.index import npz as npz_mod
from memo_tpu_torch.index.placement import upload_columns
from memo_tpu_torch.index.store import COLUMNS, IntervalStore
from memo_tpu_torch.query.engine import QueryEngine
from memo_tpu_torch.utils.profiling import GLOBAL_TIMES
from window_cases import REC_LEN, case_arrays

STORES = {"one_record": "ms_one", "several_records": "ms_records",
          "record_without_rows": "empty_record", "zero_rows": "empty_store"}
WRITERS = ["memo_tpu", "port_deflated", "port_stored"]
FIELDS = ("record_lens", "rec_id", "start", "end", "order", "rec_offsets", "max_interval_len")


def _store(case: str, kind: str = "conservation") -> IntervalStore:
    return IntervalStore(kind=kind, **case_arrays(STORES[case]))


def _save(store: IntervalStore, writer: str, path) -> None:
    if writer == "memo_tpu":
        RefStore(record_names=store.record_names, record_lens=store.record_lens,
                 n_docs=store.n_docs, kind=store.kind, rec_id=store.rec_id, start=store.start,
                 end=store.end, order=store.order).save(path)
    else:
        store.save(path, compressed=writer == "port_deflated")


def _digest(path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


@pytest.mark.parametrize("case", list(STORES))
@pytest.mark.parametrize("writer", WRITERS)
def test_load_equals_memo_tpus(tmp_path, monkeypatch, writer, case):
    """Array for array and dtype for dtype, from either package's writer,
    stored or deflated (host reads of stored members in chunks of 4 KB);
    reading the columns and streaming them writes nothing to the file."""
    monkeypatch.setattr(npz_mod, "CHUNK_BYTES", 4096)
    path = tmp_path / "idx.npz"
    _save(_store(case), writer, path)
    before = _digest(path)
    mine, theirs = IntervalStore.load(path), RefStore.load(path)
    assert (mine.record_names, mine.n_docs, mine.kind) == (theirs.record_names, theirs.n_docs,
                                                           theirs.kind)
    assert mine.num_intervals == theirs.num_intervals
    assert mine.file_columns()[1] == list(COLUMNS)  # nothing read on the host yet
    cols = upload_columns(mine, "cpu")
    for name, col in zip(COLUMNS, cols):
        want = getattr(theirs, name)
        assert col.numpy().dtype == want.dtype and np.array_equal(col.numpy(), want), name
    assert mine.file_columns()[1] == list(COLUMNS)  # streamed, not read on the host
    for name in FIELDS:
        got, want = getattr(mine, name), getattr(theirs, name)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert np.array_equal(got, want), name
    assert mine.file_columns()[1] == []
    assert _digest(path) == before


@pytest.mark.parametrize("chunk_bytes", [4096, 1000])
@pytest.mark.parametrize("writer", ["port_deflated", "port_stored"])
def test_streamed_upload_equals_in_memory_upload(tmp_path, monkeypatch, writer, chunk_bytes):
    """Staging chunks of a few KB (many per column, a partial last one, and
    with 1000 bytes chunks that cut elements): the streamed columns equal
    the in-memory store's upload, with the stages beside ``place.upload``;
    a column read on the host first goes up from the host."""
    store = _store("several_records")
    assert store.end.nbytes > 4 * chunk_bytes and store.end.nbytes % chunk_bytes
    monkeypatch.setattr(npz_mod, "CHUNK_BYTES", chunk_bytes)
    path = tmp_path / "idx.npz"
    _save(store, writer, path)
    want = upload_columns(store, "cpu")
    GLOBAL_TIMES.times.clear()
    got = upload_columns(IntervalStore.load(path), "cpu")
    assert {"place.upload", "place.upload.read", "place.upload.copy"} <= set(GLOBAL_TIMES.times)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    loaded = IntervalStore.load(path)
    loaded.start  # read on the host: uploaded from there
    assert loaded.file_columns()[1] == ["rec_id", "end", "order"]
    for g, w in zip(upload_columns(loaded, "cpu"), want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("writer", WRITERS)
def test_fused_query_reads_no_large_member_through_numpy(tmp_path, monkeypatch, writer):
    """With numpy's member reader refusing any array over R + 1 elements,
    the loaded store through the fused engine and through the CLI's ``-r``
    gives memo_tpu's numpy-oracle output, and no column is read on the host."""
    store = _store("several_records")
    path = tmp_path / "idx.npz"
    _save(store, writer, path)
    regions = [("chr1", 0, REC_LEN), ("chr2", 37, 290)]
    oracle = JaxEngine(RefStore.load(path), backend="numpy")
    want = {(r, k): oracle.conservation(*r, k) for r in regions for k in (3, 31)}
    assert ref_cli.main(["query", "-b", str(path), "-k", "3", "-r", "chr1:5-390", "-o",
                         str(tmp_path / "ref.txt"), "--backend", "numpy"]) == 0

    real, R = np.lib.format.read_array, store.num_records

    def small_only(*args, **kwargs):
        arr = real(*args, **kwargs)
        if arr.size > R + 1:
            raise AssertionError(f"numpy's reader read an array of {arr.size} elements")
        return arr

    monkeypatch.setattr(np.lib.format, "read_array", small_only)
    loaded = IntervalStore.load(path)
    eng = QueryEngine(loaded, backend="fused", device="cpu")
    for (region, k), out in want.items():
        assert np.array_equal(eng.conservation(*region, k), out), (region, k)
    assert loaded.file_columns()[1] == list(COLUMNS)
    assert cli.main(["query", "-b", str(path), "-k", "3", "-r", "chr1:5-390", "-o",
                     str(tmp_path / "got.txt"), "--device", "cpu"]) == 0
    assert (tmp_path / "got.txt").read_bytes() == (tmp_path / "ref.txt").read_bytes()


def _error(fn):
    try:
        fn()
    except Exception as err:  # the type is what the test compares
        return type(err)
    return None


def _np_load_all(path):
    with np.load(path) as z:
        return [z[key] for key in z.files]


def _port_load_all(path):
    store = IntervalStore.load(path)
    upload_columns(store, "cpu")
    return [getattr(store, name) for name in FIELDS]


def _corrupt(path, how: str) -> None:
    data = bytearray(path.read_bytes())
    with zipfile.ZipFile(path) as zf:
        info = zf.getinfo("start.npy")
    local = data.find(b"start.npy", info.header_offset)  # the local header's name
    magic = data.find(b"\x93NUMPY", local)
    if how == "truncated_half":
        del data[len(data) // 2:]
    elif how == "truncated_tail":
        del data[-10:]
    elif how == "bad_member_magic":
        data[magic:magic + 6] = b"\x93NUMPX"
    elif how == "bad_crc":  # one bit of start's data flipped
        data[magic + 128 + 8] ^= 1
    elif how == "empty":
        data = bytearray()
    elif how == "not_a_zip":
        data[:4] = b"\x00\x01\x02\x03"
    path.write_bytes(bytes(data))


@pytest.mark.parametrize("how", ["truncated_half", "truncated_tail", "bad_member_magic", "bad_crc",
                                 "empty", "not_a_zip"])
def test_bad_files_raise_as_np_load_does(tmp_path, monkeypatch, how):
    """A truncated file, a bad member magic number, a flipped data bit, an
    empty file and a file that is no zip: the port's load (with its column
    reads and its streamed upload) raises the exception type ``np.load``'s
    reads raise, as memo_tpu's load does; none returns arrays."""
    monkeypatch.setattr(npz_mod, "CHUNK_BYTES", 4096)  # stored members in several chunks
    path = tmp_path / "idx.npz"
    _save(_store("several_records"), "port_stored", path)
    _corrupt(path, how)
    want = _error(lambda: _np_load_all(path))
    assert want is not None
    assert _error(lambda: RefStore.load(path)) is want
    assert _error(lambda: _port_load_all(path)) is want
    assert _error(lambda: [npz_mod.NpzMembers(path).read(n) for n in ("meta", "start")]) is want


def _npy_bytes(arr) -> bytes:
    import io

    buf = io.BytesIO()
    np.lib.format.write_array(buf, arr, allow_pickle=True)
    return buf.getvalue()


ARRAYS = {
    "int64": np.arange(-5, 1000, 3, dtype=np.int64),
    "int32_2d": np.arange(60, dtype=np.int32).reshape(6, 10),
    "fortran_2d": np.asfortranarray(np.arange(60, dtype=np.int64).reshape(6, 10)),
    "big_endian": np.arange(17, dtype=">i8"),
    "scalar": np.array(7, np.int64),
    "empty": np.zeros(0, np.int32),
    "uint8": np.frombuffer(b'{"magic": "x"}', np.uint8),
    "float": np.linspace(0, 1, 33),
    "objects": np.array([1, "a"], dtype=object),
    "no_magic": b"not an array",  # np.load returns such a member's bytes
}


@pytest.mark.parametrize("method", ["stored", "deflated", "bzip2", "lzma"])
def test_members_read_as_np_load_reads(tmp_path, monkeypatch, method):
    """Every member, in every compression method zipfile reads (numpy
    writes the first two): equal to ``np.load``'s array (or its bytes, for
    a member without the ``.npy`` magic), or the same exception (object
    arrays without pickles); the direct ones also stream equal in chunks of
    a few KB."""
    compression = {"stored": zipfile.ZIP_STORED, "deflated": zipfile.ZIP_DEFLATED,
                   "bzip2": zipfile.ZIP_BZIP2, "lzma": zipfile.ZIP_LZMA}[method]
    path = tmp_path / "a.npz"
    with zipfile.ZipFile(path, "w", compression) as zf:
        for name, arr in ARRAYS.items():
            zf.writestr(name + ".npy", arr if isinstance(arr, bytes) else _npy_bytes(arr))
    members = npz_mod.NpzMembers(path)
    direct = []
    with np.load(path) as z:
        for name in ARRAYS:
            want_err = _error(lambda: z[name])
            if want_err is not None:
                assert _error(lambda: members.read(name)) is want_err, name
                continue
            want, got = z[name], members.read(name)
            if isinstance(want, bytes):
                assert got == want and not members.member(name).direct
                continue
            assert got.dtype == want.dtype and got.shape == want.shape, name
            assert np.array_equal(got, want) and got.flags.aligned, name
            if members.member(name).direct:
                direct.append(name)
    assert bool(direct) == (method in ("stored", "deflated"))
    if direct:
        monkeypatch.setattr(npz_mod, "CHUNK_BYTES", 64)
        streamed, _ = members.stream(direct, "cpu")
        for name in direct:
            assert np.array_equal(streamed[name].numpy(), ARRAYS[name]), name


def test_a_file_changed_after_load_is_not_read(tmp_path):
    """A column still in the file is read from the file the member table
    describes, or not at all."""
    path = tmp_path / "idx.npz"
    _save(_store("several_records"), "port_stored", path)
    loaded = IntervalStore.load(path)
    _save(_store("one_record"), "port_stored", path)
    with pytest.raises(RuntimeError, match="changed"):
        loaded.start
    with pytest.raises(RuntimeError, match="changed"):
        upload_columns(loaded, "cpu")


def test_crc32_combine_equals_zlib():
    """The CRC-32 of two pieces joined, from theirs: zlib's ``crc32_combine``."""
    rng = np.random.default_rng(7)
    for n_a, n_b in [(0, 0), (0, 5), (5, 0), (1, 1), (4096, 1000), (12345, 3 << 20)]:
        a, b = rng.bytes(n_a), rng.bytes(n_b)
        assert npz_mod._crc32_combine(zlib.crc32(a), zlib.crc32(b), n_b) == zlib.crc32(a + b)
