"""The arrays of a ``.npz`` file, read without numpy's member reader, and
streamed from the file into device memory through small staging buffers.

``np.load`` reads a member through ``zipfile.ZipExtFile``, 256 KB at a time,
and copies each piece into the array. Here the zip's member table gives each
member's compression method, the file offset of its data (from the member's
**local** header: numpy writes with ``force_zip64=True``, so the local extra
field differs from the central directory's) and its sizes; the ``.npy``
header inside gives dtype, shape and order. A stored member is then read at
its offset, a deflated one inflated from its raw stream, and either checked
against the member's CRC-32 as ``zipfile`` checks it.

:meth:`NpzMembers.stream` fills tensors on a device from the members: each
worker thread owns a ring of staging buffers (pinned on CUDA), fills one with
the next piece of a member (a stored member's pieces are read in parallel at
their offsets; a deflated member is inflated in order, one thread per
member, so the members inflate at once), and copies it to the device on its
own stream without waiting; a buffer is filled again only after its last
copy has completed. Every byte passes once from the file into a buffer and
once from there to the device. Given row ranges, it sends only those rows:
a stored member is read at their offsets alone, a deflated one inflated in
order with the bytes outside them dropped. :meth:`NpzMembers.search` finds a
row of a stored, sorted column by reading single elements at their offsets.

Members numpy never writes this way (another compression method, a
``fortran_order`` array of more than one dimension, an object dtype, a
byte order not the host's, a header version the public readers do not
parse, no ``.npy`` magic string) are read by ``np.load`` itself, so every
file ``np.load`` reads still reads, and what it refuses is refused with the
same exception.
"""

from __future__ import annotations

import contextlib
import functools
import io
import os
import queue
import struct
import threading
import time
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch
from numpy.lib import format as npy_format

CHUNK_BYTES = 16 << 20  # one staging buffer
RING = 2  # staging buffers a worker fills in turn
MAX_WORKERS = 8
INFLATE_INPUT = 4 << 20  # compressed bytes read at a time
SKIP_BYTES = 4 << 20  # inflated bytes dropped at a time
_LOCAL_HEADER = struct.Struct("<4s5H3L2H")  # zip local file header, 30 bytes
_LOCAL_MAGIC = b"PK\x03\x04"
_ZIP_PREFIXES = (b"PK\x03\x04", b"PK\x05\x06")  # what np.load takes for a zip
_DIRECT = (zipfile.ZIP_STORED, zipfile.ZIP_DEFLATED)
_HEADER_READERS = {(1, 0): npy_format.read_array_header_1_0,
                   (2, 0): npy_format.read_array_header_2_0}


@dataclass(frozen=True)
class Member:
    """One ``.npy`` member of the archive. ``dtype`` and ``shape`` are
    None, and ``header_len`` 0, where the member is not read directly
    (:attr:`direct`)."""

    name: str  # the array's name: the member's, less ".npy"
    method: int  # zipfile.ZIP_STORED, ZIP_DEFLATED, or another method zipfile reads
    offset: int  # file offset of the member's data (its compressed bytes)
    compressed_size: int
    size: int  # uncompressed bytes: the .npy header, then the array
    crc: int
    header_len: int
    dtype: np.dtype | None
    shape: tuple[int, ...] | None

    @property
    def direct(self) -> bool:
        """The member is stored or deflated, and its bytes after the header
        are the array's in C order and native byte order: the readers here
        take it."""
        return self.dtype is not None

    @property
    def nbytes(self) -> int:
        return self.size - self.header_len


def _parse_header(fp) -> tuple[int, np.dtype, tuple[int, ...]] | None:
    """(header length, dtype, shape) of the ``.npy`` stream ``fp``, or None
    where the member is not read directly (np.load returns a member without
    the ``.npy`` magic string as its raw bytes)."""
    head = fp.read(npy_format.MAGIC_LEN)
    if not head.startswith(npy_format.MAGIC_PREFIX):
        return None
    reader = _HEADER_READERS.get(npy_format.read_magic(io.BytesIO(head)))
    if reader is None:
        return None
    shape, fortran_order, dtype = reader(fp)
    if dtype.hasobject or not dtype.isnative or (fortran_order and len(shape) > 1):
        return None
    return fp.tell(), dtype, tuple(shape)  # at most 1-d if Fortran-ordered: C-order bytes


def _member(fh, zf: zipfile.ZipFile, info: zipfile.ZipInfo, file_size: int) -> Member:
    """The table entry of one ``.npy`` member of the open archive ``zf`` over ``fh``."""
    parsed = None
    if info.compress_type in _DIRECT:
        with zf.open(info) as fp:
            parsed = _parse_header(fp)
    fh.seek(info.header_offset)
    raw = fh.read(_LOCAL_HEADER.size)
    if len(raw) < _LOCAL_HEADER.size or raw[:4] != _LOCAL_MAGIC:
        raise zipfile.BadZipFile("Bad magic number for file header")
    name_len, extra_len = _LOCAL_HEADER.unpack(raw)[-2:]
    offset = info.header_offset + _LOCAL_HEADER.size + name_len + extra_len
    if offset + info.compress_size > file_size:
        raise EOFError(f"member {info.filename} is truncated")
    header_len, dtype, shape = parsed or (0, None, None)
    return Member(info.filename[: -len(".npy")], info.compress_type, offset, info.compress_size,
                  info.file_size, info.CRC, header_len, dtype, shape)


class NpzMembers:
    """The member table of the ``.npz`` at ``path``, and readers of its
    arrays. The file is opened anew for each read, and a read raises if the
    file is no longer the one the table was made from."""

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        st = os.stat(self.path)
        self._identity = (st.st_dev, st.st_ino, st.st_size, st.st_mtime_ns)
        with open(self.path, "rb") as fh:
            # np.load's test of what the file is: a zip, or no archive.
            magic = fh.read(len(npy_format.MAGIC_PREFIX))
            if not magic:
                raise EOFError("No data left in file")
            if not magic.startswith(_ZIP_PREFIXES):
                raise ValueError(f"{self.path} is not a .npz archive")
            fh.seek(0)
            with zipfile.ZipFile(fh) as zf:
                self.members = {info.filename[: -len(".npy")]: _member(fh, zf, info, st.st_size)
                                for info in zf.infolist() if info.filename.endswith(".npy")}

    def member(self, name: str) -> Member:
        try:
            return self.members[name]
        except KeyError:
            raise KeyError(f"{name} is not a file in the archive") from None

    @contextlib.contextmanager
    def _open(self):
        fd = os.open(self.path, os.O_RDONLY)
        try:
            st = os.fstat(fd)
            if (st.st_dev, st.st_ino, st.st_size, st.st_mtime_ns) != self._identity:
                raise RuntimeError(f"{self.path} changed since its member table was read")
            yield fd
        finally:
            os.close(fd)

    def read(self, name: str) -> np.ndarray:
        """The array ``name`` on the host, equal to ``np.load(path)[name]``:
        a stored member read at its offset (its chunks in parallel), a
        deflated one inflated, either checked against its CRC-32."""
        m = self.member(name)
        if not m.direct:
            with np.load(self.path) as z:
                return z[name]
        arr = np.empty(m.shape, m.dtype)
        out = memoryview(arr.reshape(-1).view(np.uint8))
        with self._open() as fd:
            if m.method == zipfile.ZIP_STORED:  # its chunks in parallel, at their offsets
                def chunk(lo: int) -> tuple[int, int]:
                    piece = out[lo : lo + CHUNK_BYTES]
                    _pread_into(fd, piece, m.offset + m.header_len + lo, m)
                    return zlib.crc32(piece), len(piece)

                starts = range(0, len(out), CHUNK_BYTES)
                with ThreadPoolExecutor(max_workers=_workers(len(starts))) as pool:
                    _check_stored_crc(fd, m, list(pool.map(chunk, starts)))
            else:
                inflater = _Inflater(fd, m)
                inflater.skip(m.header_len)
                if inflater.readinto(out) < len(out):
                    raise EOFError(f"{self.path}: member {m.name}.npy is truncated")
                inflater.finish()
        return arr

    def stream(self, names, device, rows=None) -> tuple[dict[str, torch.Tensor], dict[str, float]]:
        """The direct members ``names`` as tensors on ``device`` (their
        dtypes and shapes), filled through staging buffers of
        ``CHUNK_BYTES``: pinned, with non-blocking copies, on CUDA; plain
        buffers and copies on the CPU. With ``rows``, [lo, hi) ranges of the
        members' first axis, ascending and disjoint, each tensor holds only
        those rows, in that order: a stored member is read at their offsets
        only, a deflated one is inflated whole and the bytes outside them
        dropped. Returns the tensors and the stage seconds: ``read``, the
        thread-seconds spent filling buffers (read or inflate, and the CRC),
        and ``copy``, the copies' seconds (device time on CUDA).

        A deflated member that any row is read from is checked against its
        CRC-32, and a stored one wherever it is read whole (``rows`` None,
        or ranges that cover every row). A stored member read only in part
        cannot be checked against the CRC-32 of the whole member; its reads
        are held, as :meth:`read` holds them, to the member's length (a
        short read raises) and to the file the member table was made from.
        Any failure raises."""
        device, chunk_bytes = torch.device(device), CHUNK_BYTES
        members = [self.member(n) for n in names]
        for m in members:
            if not m.direct:
                raise ValueError(f"{self.path}: member {m.name}.npy is not a plain array")
        spans = {m.name: _spans(m, rows) for m in members}
        dests = {m.name: torch.empty(_rows_shape(m, rows), dtype=_torch_dtype(m.dtype),
                                     device=device)
                 for m in members}
        # A deflated member is one job (its stream inflates in order), where
        # any of it is asked for; a stored member is one job per chunk of
        # each span, read at its offset.
        jobs = [(m, None) for m in members if m.method == zipfile.ZIP_DEFLATED and spans[m.name]]
        jobs += [(m, (lo, min(lo + chunk_bytes, hi), at + lo - a))
                 for m in members if m.method == zipfile.ZIP_STORED
                 for a, hi, at in spans[m.name] for lo in range(a, hi, chunk_bytes)]
        n_workers = _workers(len(jobs))
        rings = queue.SimpleQueue()
        all_rings = [_Ring(chunk_bytes, device) for _ in range(n_workers)]
        for ring in all_rings:
            rings.put(ring)
        stop = threading.Event()
        byte_views = {name: t.view(-1).view(torch.uint8) for name, t in dests.items()}

        def run(m: Member, job: tuple[int, int, int] | None, fd: int):
            if stop.is_set():
                return None
            ring = rings.get()
            try:
                dest = byte_views[m.name]
                if job is None:
                    return _inflate_job(fd, m, dest, ring, chunk_bytes, stop, spans[m.name])
                lo, hi, at = job
                return _stored_job(fd, m, lo, hi, dest[at : at + hi - lo], ring)
            finally:
                rings.put(ring)

        crcs: dict[str, list[tuple[int, int]]] = {m.name: [] for m in members}  # stored chunks'
        with self._open() as fd:
            try:
                with ThreadPoolExecutor(max_workers=n_workers) as pool:
                    futures = [(m, job, pool.submit(run, m, job, fd)) for m, job in jobs]
                    try:
                        for m, job, fut in futures:
                            got = fut.result()
                            if job is not None:
                                crcs[m.name].append((got, job[1] - job[0]))
                    except BaseException:
                        stop.set()
                        raise
            finally:
                for ring in all_rings:
                    ring.wait()
            for m in members:
                if m.method == zipfile.ZIP_STORED and _covers(spans[m.name], m.nbytes):
                    _check_stored_crc(fd, m, crcs[m.name])
        times = {"read": sum(r.read_s for r in all_rings),
                 "copy": sum(r.copy_seconds() for r in all_rings)}
        return dests, times

    def search(self, name: str, lo: int, hi: int, values) -> list[int]:
        """For each of ``values``, the first row in [lo, hi) of the stored
        integer column ``name`` whose element is not below it, or ``hi``:
        ``lo + np.searchsorted(column[lo:hi], v)`` over rows in ascending
        order. A binary search that reads one element a step at its offset
        in the file, about log2(hi - lo) reads a value. A short read raises,
        as in :meth:`read`; the CRC-32 of the member cannot be checked."""
        m = self.member(name)
        if not (m.direct and m.method == zipfile.ZIP_STORED and len(m.shape) == 1
                and m.dtype.kind in "iu"):
            raise ValueError(f"{self.path}: member {name}.npy is not a stored integer column")
        if not 0 <= lo <= hi <= m.shape[0]:
            raise ValueError(f"rows [{lo}, {hi}) outside member {name}.npy of {m.shape[0]} rows")
        size, base = m.dtype.itemsize, m.offset + m.header_len
        found = []
        with self._open() as fd:
            def element(i: int) -> int:
                raw = os.pread(fd, size, base + i * size)
                if len(raw) < size:
                    raise EOFError(f"member {name}.npy is truncated")
                return int(np.frombuffer(raw, m.dtype)[0])

            for v in values:
                a, b = lo, hi
                while a < b:
                    mid = (a + b) // 2
                    if element(mid) < v:
                        a = mid + 1
                    else:
                        b = mid
                found.append(a)
        return found


def _spans(m: Member, rows) -> list[tuple[int, int, int]]:
    """The array bytes [lo, hi) of ``rows`` of member ``m``, each with its
    offset in the destination: (lo, hi, at), ascending; the whole array for
    None. Empty ranges have none."""
    if rows is None:
        return [(0, m.nbytes, 0)]
    if not m.shape:
        raise ValueError(f"member {m.name}.npy has no rows")
    row_bytes = m.dtype.itemsize * int(np.prod(m.shape[1:], dtype=np.int64))
    spans, last, at = [], 0, 0
    for lo, hi in rows:
        lo, hi = int(lo), int(hi)
        if not last <= lo <= hi <= m.shape[0]:
            raise ValueError(f"row ranges {rows} are not ascending, disjoint ranges of "
                             f"member {m.name}.npy's {m.shape[0]} rows")
        if hi > lo:
            spans.append((lo * row_bytes, hi * row_bytes, at))
            at += (hi - lo) * row_bytes
        last = hi
    return spans


def _rows_shape(m: Member, rows) -> tuple[int, ...]:
    if rows is None:
        return m.shape
    return (sum(int(hi) - int(lo) for lo, hi in rows),) + m.shape[1:]


def _covers(spans: list[tuple[int, int, int]], n_bytes: int) -> bool:
    """The spans, in order, are the whole array: each starts where the
    last ended, from 0 to ``n_bytes``."""
    end = 0
    for lo, hi, _ in spans:
        if lo != end:
            return False
        end = hi
    return end == n_bytes


def _workers(n_jobs: int) -> int:
    return max(1, min(MAX_WORKERS, len(os.sched_getaffinity(0)), n_jobs))


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


def _check_crc(m: Member, crc: int) -> None:
    if crc != m.crc:
        raise zipfile.BadZipFile(f"Bad CRC-32 for file {m.name}.npy")


def _check_stored_crc(fd: int, m: Member, pieces: list[tuple[int, int]]) -> None:
    """A stored member's CRC-32, from its header's and the (CRC-32, length)
    of each piece of its array, in order, pieces that make the whole."""
    header = os.pread(fd, m.header_len, m.offset)
    if len(header) < m.header_len:
        raise EOFError(f"member {m.name}.npy is truncated")
    crc = zlib.crc32(header)
    for piece, n in pieces:
        crc = _crc32_combine(crc, piece, n)
    _check_crc(m, crc)


def _pread_into(fd: int, out: memoryview, offset: int, m: Member) -> None:
    """Fill ``out`` from the file at ``offset`` (a read may return less
    than asked: Linux caps one read below 2 GiB)."""
    done = 0
    while done < len(out):
        got = os.preadv(fd, [out[done:]], offset + done)
        if got == 0:
            raise EOFError(f"member {m.name}.npy is truncated")
        done += got


class _Inflater:
    """The uncompressed bytes of a deflated member, in order, inflated from
    its raw stream, with their running CRC-32."""

    def __init__(self, fd: int, m: Member):
        self._fd, self._m = fd, m
        self._next, self._left = m.offset, m.compressed_size
        self._d = zlib.decompressobj(-15)
        self._tail = b""
        self.crc = 0

    def readinto(self, out: memoryview) -> int:
        """Fill ``out`` as far as the stream goes; returns the bytes written."""
        n = 0
        while n < len(out) and not self._d.eof:
            if not self._tail and self._left:
                want = min(INFLATE_INPUT, self._left)
                self._tail = os.pread(self._fd, want, self._next)
                if len(self._tail) < want:
                    raise EOFError(f"member {self._m.name}.npy is truncated")
                self._next += want
                self._left -= want
            data = self._d.decompress(self._tail, len(out) - n)
            self._tail = self._d.unconsumed_tail
            out[n : n + len(data)] = data
            n += len(data)
            if not data and not self._tail and not self._left and not self._d.eof:
                raise EOFError("Compressed file ended before the end-of-stream marker was reached")
        self.crc = zlib.crc32(out[:n], self.crc)
        return n

    def skip(self, n: int) -> None:
        """Inflate the next ``n`` bytes and drop them (the CRC-32 counts them)."""
        scratch = memoryview(bytearray(min(n, SKIP_BYTES)))
        while n:
            step = min(n, len(scratch))
            if self.readinto(scratch[:step]) < step:
                raise EOFError(f"member {self._m.name}.npy is truncated")
            n -= step

    def finish(self) -> None:
        """The stream must end here, with the member's CRC-32."""
        if self.readinto(memoryview(bytearray(1))) or not self._d.eof:
            raise zipfile.BadZipFile(f"member {self._m.name}.npy is not {self._m.size} bytes")
        _check_crc(self._m, self.crc)


class _Ring:
    """A worker's staging buffers, filled in turn, each with the event that
    its last copy to the device completes (CUDA) on the ring's own stream."""

    def __init__(self, chunk_bytes: int, device: torch.device):
        cuda = device.type == "cuda"
        self.bufs = [torch.empty(chunk_bytes, dtype=torch.uint8, pin_memory=cuda)
                     for _ in range(RING)]
        self.views = [memoryview(b.numpy()) for b in self.bufs]
        self.done: list[torch.cuda.Event | None] = [None] * RING
        self.stream = None
        if cuda:
            self.stream = torch.cuda.Stream(device)
            self.stream.wait_stream(torch.cuda.current_stream(device))  # the destinations' allocation
        self.turn = 0
        self.read_s = 0.0
        self.copy_s = 0.0
        self.copy_events: list[tuple[torch.cuda.Event, torch.cuda.Event]] = []

    def take(self) -> int:
        """The next buffer, once its last copy has completed."""
        i = self.turn
        self.turn = (i + 1) % RING
        if self.done[i] is not None:
            self.done[i].synchronize()
        return i

    def send(self, i: int, dest: torch.Tensor, n: int) -> None:
        """Copy the first ``n`` bytes of buffer ``i`` into ``dest``."""
        if self.stream is None:
            t0 = time.perf_counter()
            dest.copy_(self.bufs[i][:n])
            self.copy_s += time.perf_counter() - t0
            return
        with torch.cuda.stream(self.stream):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            dest.copy_(self.bufs[i][:n], non_blocking=True)
            end.record()
        self.done[i] = end
        self.copy_events.append((start, end))

    def wait(self) -> None:
        if self.stream is not None:
            self.stream.synchronize()

    def copy_seconds(self) -> float:
        return self.copy_s + sum(a.elapsed_time(b) for a, b in self.copy_events) / 1e3


def _stored_job(fd: int, m: Member, lo: int, hi: int, dest: torch.Tensor, ring: _Ring) -> int:
    """Array bytes [lo, hi) of a stored member into ``dest`` (their
    ``hi - lo`` bytes); returns their CRC-32."""
    i = ring.take()
    t0 = time.perf_counter()
    out = ring.views[i][: hi - lo]
    _pread_into(fd, out, m.offset + m.header_len + lo, m)
    crc = zlib.crc32(out)
    ring.read_s += time.perf_counter() - t0
    ring.send(i, dest, hi - lo)
    return crc


def _inflate_job(fd: int, m: Member, dest: torch.Tensor, ring: _Ring, chunk_bytes: int,
                 stop: threading.Event, spans: list[tuple[int, int, int]]) -> None:
    """A deflated member's array bytes ``spans`` (:func:`_spans`) into
    ``dest``, one buffer at a time; the bytes between and after them are
    inflated and dropped, so that the whole stream meets its CRC-32."""
    t0 = time.perf_counter()
    inflater = _Inflater(fd, m)
    inflater.skip(m.header_len)
    ring.read_s += time.perf_counter() - t0
    done = 0  # array bytes inflated so far
    for a, b, at in spans:
        t0 = time.perf_counter()
        inflater.skip(a - done)
        ring.read_s += time.perf_counter() - t0
        for lo in range(a, b, chunk_bytes):
            if stop.is_set():
                return None
            n = min(chunk_bytes, b - lo)
            i = ring.take()
            t0 = time.perf_counter()
            if inflater.readinto(ring.views[i][:n]) < n:
                raise EOFError(f"member {m.name}.npy is truncated")
            ring.read_s += time.perf_counter() - t0
            ring.send(i, dest[at + lo - a : at + lo - a + n], n)
        done = b
    t0 = time.perf_counter()
    inflater.skip(m.nbytes - done)
    inflater.finish()
    ring.read_s += time.perf_counter() - t0
    return None


def _gf2_times(mat, vec: int) -> int:
    out, i = 0, 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


def _gf2_product(a: list[int], b: list[int]) -> list[int]:
    return [_gf2_times(a, col) for col in b]


_ZERO_BIT = [0xEDB88320] + [1 << n for n in range(31)]  # append one zero bit to a CRC-32


def _square(mat: list[int]) -> list[int]:
    return _gf2_product(mat, mat)


_ZERO_BYTE = _square(_square(_square(_ZERO_BIT)))


@functools.lru_cache(maxsize=64)
def _shift(n_bytes: int) -> tuple[int, ...]:
    """The operator that appends ``n_bytes`` zero bytes to a CRC-32."""
    op, power, n = [1 << k for k in range(32)], _ZERO_BYTE, n_bytes
    while n:
        if n & 1:
            op = _gf2_product(power, op)
        power = _square(power)
        n >>= 1
    return tuple(op)


def _crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """``zlib.crc32(a + b)`` from ``crc32(a)``, ``crc32(b)`` and ``len(b)``
    (zlib's ``crc32_combine``, which Python's zlib does not expose)."""
    return _gf2_times(_shift(len2), crc1) ^ crc2
