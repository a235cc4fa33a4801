"""MEM / MEM-overlap interval extraction from matching statistics.

This replaces the reference's streaming Python row loop
(reference dap_to_bed.py:116-134) with dense vectorized array transforms.

Semantics reproduced exactly (verified against the reference as oracle):

- A position ``p`` starts a MEM for column ``j`` iff ``ms[p-1, j] <= ms[p, j]``;
  the first row of every record emits all columns (dap_to_bed.py:122-130).
  The MEM interval is ``[p, p + ms[p, j])``.
- ``order`` mode sorts each row's MS values descending first, decoupling
  columns from documents (dap_to_bed.py:89-90) — "order MEMs".
- ``overlap`` mode emits, per column, the overlap between consecutive MEMs
  ``[max(starts), min(ends))`` when non-negative length — bookends (zero
  length) included (dap_to_bed.py:93-109).
- At the end of each record a sentinel DAP row ``pos=L, ms=[L]*D`` is
  processed, producing past-the-end intervals ``[L, min(prev_end, 2L))``
  (dap_to_bed.py:125-134); these are neutralized by query-time clipping but
  are reproduced for index byte-parity.
- Emission order is row-major (position, then column) — the order the
  reference prints BED lines in.

The port's own copy of :mod:`memo_tpu.index.intervals`, which stays the reference; the two
read and write the same files.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class _ColumnCarry:
    """Streaming state carried between row chunks: per column, the last
    emitted MEM interval (the reference's ``prev_mem_intervals_by_order``,
    dap_to_bed.py:74) plus the previous MS row for the MEM rule."""

    prev_start: np.ndarray  # int64[D], -1 if none
    prev_end: np.ndarray  # int64[D]
    prev_ms_row: np.ndarray | None  # [D] last MS row seen, None at record start

    @classmethod
    def fresh(cls, n_cols: int) -> "_ColumnCarry":
        return cls(
            prev_start=np.full(n_cols, -1, np.int64),
            prev_end=np.full(n_cols, -1, np.int64),
            prev_ms_row=None,
        )


def _emit_chunk(
    ms: np.ndarray,  # int[P, D] MS rows of this chunk (already order-sorted if needed)
    pos0: int,  # global position of the first row within the record
    carry: _ColumnCarry,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, _ColumnCarry]:
    """Emit overlap intervals for one chunk of DAP rows, updating carry.

    Returns (starts, ends, orders) in emission order; orders are 1-based
    column indices (dap_to_bed.py:52, enumerate start=1).
    """
    P, D = ms.shape
    pos = pos0 + np.arange(P, dtype=np.int64)

    # MEM rule: emit iff prev_ms <= cur_ms; very first row of a record emits all.
    emit = np.empty((P, D), dtype=bool)
    if carry.prev_ms_row is None:
        emit[0] = True
    else:
        emit[0] = carry.prev_ms_row <= ms[0]
    if P > 1:
        emit[1:] = ms[:-1] <= ms[1:]

    mem_end = pos[:, None] + ms.astype(np.int64)

    # Index of the previous emitted row per (row, column), -1 if none in chunk.
    row_idx = np.arange(P, dtype=np.int64)[:, None]
    ridx = np.where(emit, row_idx, np.int64(-1))
    last = np.maximum.accumulate(ridx, axis=0)
    prev = np.empty_like(last)
    prev[0] = -1
    prev[1:] = last[:-1]

    cols = np.arange(D)
    prev_safe = np.maximum(prev, 0)
    prev_start = np.where(prev >= 0, pos[prev_safe], carry.prev_start[None, :])
    prev_end = np.where(prev >= 0, mem_end[prev_safe, cols[None, :]], carry.prev_end[None, :])
    has_prev = (prev >= 0) | (carry.prev_start >= 0)[None, :]

    # Overlap between consecutive MEMs: starts strictly increase, so
    # max(starts) == current start; bookends (end == start) are kept.
    ov_start = np.broadcast_to(pos[:, None], (P, D))
    ov_end = np.minimum(prev_end, mem_end)
    out_mask = emit & has_prev & (ov_end >= ov_start)

    rows, colsel = np.nonzero(out_mask)  # row-major == reference print order
    starts = pos[rows]
    ends = ov_end[rows, colsel]
    orders = colsel.astype(np.int64) + 1

    # Update carry with the last emitted MEM per column.
    ridx_all = np.where(emit, row_idx, np.int64(-1))
    last_row = ridx_all.max(axis=0)
    any_emit = last_row >= 0
    new_carry = _ColumnCarry(
        prev_start=np.where(any_emit, pos[np.maximum(last_row, 0)], carry.prev_start),
        prev_end=np.where(any_emit, mem_end[np.maximum(last_row, 0), cols], carry.prev_end),
        prev_ms_row=ms[-1].copy(),
    )
    return starts, ends, orders, new_carry


def _native_overlaps(
    ms: np.ndarray, L: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Streaming C++ extraction (libms ms_overlaps): one pass over the MS
    matrix, ~30x the chunked-numpy path which is bound on (P,D) int64
    temporaries. Returns None when libms is unavailable."""
    import ctypes

    from memo_tpu_torch.native.build import load_libms

    lib = load_libms()
    if lib is None:
        return None
    P, D = ms.shape
    if ms.dtype.itemsize > 4 and ms.size and int(ms.max()) > np.iinfo(np.int32).max:
        # MS values beyond int32 (records > ~2 Gbp) would silently truncate
        # in the C pass; the numpy path below is exact at int64.
        return None
    ms_c = np.ascontiguousarray(ms, np.int32)
    # Safe upper bound on emissions: rule firings between consecutive rows,
    # plus D for the sentinel row and D of slack for the first row (the
    # native pass emits nothing for row 0 — it only seeds prev_end).
    cap = int(np.count_nonzero(ms_c[:-1] <= ms_c[1:])) + 2 * D if P else 2 * D
    starts = np.empty(cap, np.int64)
    ends = np.empty(cap, np.int64)
    orders = np.empty(cap, np.int64)
    orders32 = np.empty(cap, np.int32)
    k = lib.ms_overlaps(
        ms_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        P,
        D,
        L,
        cap,
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ends.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        orders32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if k < 0:  # cap bound violated — cannot happen, but fail safe to numpy
        return None
    orders[:k] = orders32[:k]
    return starts[:k], ends[:k], orders[:k]


def mem_overlap_intervals(
    ms: np.ndarray,
    record_len: int | None = None,
    order_sort: bool = False,
    chunk_rows: int = 1 << 22,
    backend: str = "auto",
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All overlap intervals for one pivot record.

    Args:
      ms: int array ``[P, D]`` of matching statistics (P = record length,
        D = number of non-pivot documents).
      record_len: pivot record length L (defaults to P). The reference's
        sentinel row uses the .fai length (dap_to_bed.py:126-133).
      order_sort: sort each row descending first (conservation "order MEMs").
      chunk_rows: rows processed per block (bounds peak memory).
      backend: "auto" (C++ when available), "native", or "python".

    Returns (starts, ends, orders) int64 arrays in reference emission order.
    """
    ms = np.asarray(ms)
    if ms.ndim != 2:
        raise ValueError("ms must be 2-D [positions, documents]")
    P, D = ms.shape
    L = int(record_len) if record_len is not None else P

    if order_sort:
        # Row-wise descending sort (the reference's list.sort(reverse=True),
        # dap_to_bed.py:89-90).
        ms = -np.sort(-ms, axis=1)

    if backend in ("auto", "native"):
        out = _native_overlaps(ms, L)
        if out is not None:
            return out
        if backend == "native":
            from memo_tpu_torch.native.build import build_error

            raise RuntimeError(f"libms unavailable: {build_error()}")

    out_s: list[np.ndarray] = []
    out_e: list[np.ndarray] = []
    out_o: list[np.ndarray] = []
    carry = _ColumnCarry.fresh(D)
    for lo in range(0, P, chunk_rows):
        chunk = ms[lo : lo + chunk_rows]
        s, e, o, carry = _emit_chunk(chunk, lo, carry)
        out_s.append(s)
        out_e.append(e)
        out_o.append(o)

    # Sentinel end-of-record row: pos=L, ms=[L]*D. The reference prints it via
    # print_current_dap_row (dap_to_bed.py:125-134), which bypasses the MEM
    # rule — every column emits unconditionally; clearing prev_ms_row puts the
    # chunk in that "first row emits all" mode while keeping prev intervals.
    carry.prev_ms_row = None
    sent = np.full((1, D), L, dtype=np.int64)
    s, e, o, carry = _emit_chunk(sent, L, carry)
    out_s.append(s)
    out_e.append(e)
    out_o.append(o)

    return (
        np.concatenate(out_s) if out_s else np.empty(0, np.int64),
        np.concatenate(out_e) if out_e else np.empty(0, np.int64),
        np.concatenate(out_o) if out_o else np.empty(0, np.int64),
    )


class StreamingOverlapExtractor:
    """Chunk-at-a-time MEM-overlap extraction for one pivot record.

    Feeds row chunks of the (optionally order-sorted) MS matrix through the
    carry-chunked C pass (libms ms_overlaps_chunk) — the combined
    chromosome x pangenome build (128 Mbp x 90 docs) streams chunks gathered
    from per-document columns instead of materializing a ~46 GB DAP.
    Byte-identical emission order to :func:`mem_overlap_intervals`
    (property-tested). Falls back to the numpy carry path without libms.

    Usage: ``feed`` every chunk in order, then ``finish`` once.
    """

    def __init__(self, n_cols: int, record_len: int, order_sort: bool = False):
        self.D = int(n_cols)
        self.L = int(record_len)
        self.order_sort = bool(order_sort)
        self.pos = 0
        self._prev_end = np.full(self.D, -1, np.int64)
        self._prev_row = np.zeros(self.D, np.int32)
        from memo_tpu_torch.native.build import load_libms

        self._lib = load_libms()
        self._carry = None if self._lib is not None else _ColumnCarry.fresh(self.D)
        self._done = False

    def _native(self, ms: np.ndarray, is_final: bool):
        import ctypes

        P = ms.shape[0] if ms.size else 0
        ms_c = np.ascontiguousarray(ms, np.int32) if P else np.zeros((0, self.D), np.int32)
        cap = (
            int(np.count_nonzero(ms_c[:-1] <= ms_c[1:]))
            + 2 * self.D
            + (self.D if self.pos == 0 else 0)
        )
        s = np.empty(cap, np.int64)
        e = np.empty(cap, np.int64)
        o32 = np.empty(cap, np.int32)
        k = self._lib.ms_overlaps_chunk(
            ms_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            P,
            self.D,
            self.pos,
            self.L,
            1 if is_final else 0,
            self._prev_row.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self._prev_end.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            cap,
            s.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            e.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            o32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        if k < 0:  # cap bound violated — cannot happen by construction
            raise RuntimeError("ms_overlaps_chunk capacity bound violated")
        if P:
            self._prev_row = ms_c[-1].copy()
        self.pos += P
        return s[:k], e[:k], o32[:k].astype(np.int64)

    def feed(self, ms_chunk: np.ndarray):
        """Process the next row chunk; returns (starts, ends, orders)."""
        if self._done:
            raise RuntimeError("extractor already finished")
        ms_chunk = np.asarray(ms_chunk)
        if ms_chunk.ndim != 2 or ms_chunk.shape[1] != self.D:
            raise ValueError(f"chunk must be [rows, {self.D}]")
        if self.order_sort:
            ms_chunk = -np.sort(-ms_chunk, axis=1)
        if self._lib is not None:
            return self._native(ms_chunk, is_final=False)
        s, e, o, self._carry = _emit_chunk(ms_chunk, self.pos, self._carry)
        self.pos += ms_chunk.shape[0]
        return s, e, o

    def finish(self):
        """Emit the end-of-record sentinel row; returns (starts, ends, orders)."""
        if self._done:
            raise RuntimeError("extractor already finished")
        self._done = True
        if self._lib is not None:
            if self.pos == 0:  # empty record: reference emits nothing
                return (np.empty(0, np.int64),) * 3
            return self._native(np.zeros((0, self.D), np.int32), is_final=True)
        if self.pos == 0:
            return (np.empty(0, np.int64),) * 3
        self._carry.prev_ms_row = None
        sent = np.full((1, self.D), self.L, dtype=np.int64)
        s, e, o, self._carry = _emit_chunk(sent, self.L, self._carry)
        return s, e, o


def mem_intervals(
    ms: np.ndarray,
    record_len: int | None = None,
    order_sort: bool = False,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Plain MEM intervals (no ``--overlap``; reference dap_to_bed.py:108-109
    else-branch): every MEM ``[p, p+ms)`` including the sentinel row."""
    ms = np.asarray(ms)
    P, D = ms.shape
    L = int(record_len) if record_len is not None else P
    if order_sort:
        ms = -np.sort(-ms, axis=1)

    pos = np.arange(P, dtype=np.int64)
    emit = np.empty((P, D), dtype=bool)
    emit[0] = True
    if P > 1:
        emit[1:] = ms[:-1] <= ms[1:]
    rows, cols = np.nonzero(emit)
    starts = pos[rows]
    ends = starts + ms[rows, cols].astype(np.int64)
    orders = cols.astype(np.int64) + 1

    sent_starts = np.full(D, L, np.int64)
    sent_ends = np.full(D, 2 * L, np.int64)
    sent_orders = np.arange(1, D + 1, dtype=np.int64)
    return (
        np.concatenate([starts, sent_starts]),
        np.concatenate([ends, sent_ends]),
        np.concatenate([orders, sent_orders]),
    )
