"""Placement of an IntervalStore on a device, with its query layout built there.

memo_tpu builds the fused query's layout on the host (``QueryLayout.build``:
two ``np.lexsort`` permutations, their gathers and the composite keys) and
then uploads the gathered arrays. Here the store's columns go up once (a
loaded store's straight from its .npz through staging buffers,
``index/npz.py``, with no host copy of them) and
the permutations are stable ``torch.argsort``s of one composite int64 key
each, so the sorts and gathers run where the placed store lives, and the
layout stays there (:class:`DeviceLayout`): the window search
(``query/window.py``) reads the placed rows and the column keys on the
device, and only R-sized arrays (record offsets, longest interval per
record) come back to the host.

Each composite key orders rows exactly as the lexsort it replaces, ties in
row order, whatever order the store is in: with ``span`` above every
coordinate's distance from the smallest, ``seg * span + (value - lo)`` sorts
by segment, then by value. ``QueryLayout.build`` stays the plain version the
tests hold this to.

The stratified engine splits the uploaded columns into length buckets on
the device as well (:func:`split_by_length`) and places each bucket from its
rows there.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from memo_tpu_torch.index.store import COLUMNS, IntervalStore
from memo_tpu_torch.utils.profiling import GLOBAL_TIMES, stage_timer


class PlacedStore(NamedTuple):
    """The store on the device: int32 rows in start order and in end order,
    each followed by sentinel pad rows (order -1, never live)."""

    start: torch.Tensor
    end: torch.Tensor
    order: torch.Tensor
    end_s: torch.Tensor
    start_by_end: torch.Tensor
    order_by_end: torch.Tensor


@dataclass
class DeviceLayout:
    """The rest of :class:`QueryLayout` that the window search reads, beside
    the placed rows: on the device, the composite column keys ``seg *
    key_stride + value`` of the (record, order) segments and their offsets;
    on the host, the placed rows' record offsets and each record's longest
    interval (R-sized)."""

    col_offsets: torch.Tensor  # int64[R*C + 1]
    s_keys: torch.Tensor  # int64[M]; empty for an empty store or orders outside [0, C)
    e_keys: torch.Tensor  # int64[M]; likewise
    key_stride: int
    monotone: bool
    n_docs: int
    rec_offsets: np.ndarray  # int64[R + 1]: record r's rows are rec_offsets[r]:rec_offsets[r+1]
    longest: np.ndarray  # int64[R]: the longest end - start of record r's rows, 0 where none
    num_rows: int

    def device_tensors(self) -> tuple[torch.Tensor, ...]:
        return self.col_offsets, self.s_keys, self.e_keys


@contextlib.contextmanager
def _stage(name: str, device: torch.device):
    """A stage timer (``utils.profiling.GLOBAL_TIMES``) that waits for the
    device before it stops."""
    with stage_timer(name):
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def _check_keys_fit(n_segments: int, span: int) -> None:
    if n_segments * span >= 1 << 63:
        raise OverflowError(
            f"composite sort keys of {n_segments} segments x {span} positions overflow int64"
        )


I32 = torch.iinfo(torch.int32)


def _check_int32(lo: int, hi: int) -> None:
    """The placed rows are int32; the window search also needs every
    coordinate above int32's least value (``query/window.py``)."""
    if lo <= I32.min or hi > I32.max:
        raise OverflowError(f"coordinates {lo}..{hi} do not fit the device's int32 rows")


class Columns(NamedTuple):
    """A store's columns on the device, in the store's row order."""

    rec: torch.Tensor  # int32
    start: torch.Tensor  # int64
    end: torch.Tensor  # int64
    order: torch.Tensor  # int32


def upload_columns(store: IntervalStore, device) -> Columns:
    """The store's columns on ``device``, copied once. The columns of a
    loaded store that no host code has read go from its file to the device
    (``NpzMembers.stream``: staging buffers, pinned on CUDA), with the
    stages ``place.upload.read`` (thread-seconds of reads and inflates) and
    ``place.upload.copy`` (the copies' seconds) beside ``place.upload``; any
    failure there raises. A store built in memory, and a column already on
    the host or in a member format numpy never writes, goes from its host
    array."""
    device = torch.device(device)
    with _stage("place.upload", device):
        # a memo_tpu store, or any other with the columns, goes from its host arrays
        npz, in_file = store.file_columns() if isinstance(store, IntervalStore) else (None, [])
        direct = [n for n in in_file if npz.member(n).direct]
        streamed, times = npz.stream(direct, device) if direct else ({}, None)
        cols = []
        for name, dtype in COLUMNS.items():
            col = streamed.pop(name, None)
            if col is None:
                col = torch.from_numpy(getattr(store, name)).to(device)
            # a writer's other integer width, cast as IntervalStore casts it
            cols.append(col.to(getattr(torch, np.dtype(dtype).name)))
    if times is not None:
        for stage, seconds in times.items():
            GLOBAL_TIMES.add(f"place.upload.{stage}", seconds)
    return Columns(*cols)


def place_store_and_layout(store: IntervalStore, device,
                           pad: int) -> tuple[PlacedStore, DeviceLayout]:
    """:func:`place_columns` of the store's columns, uploaded once."""
    return place_columns(upload_columns(store, device), store.num_records, store.n_docs, pad)


def place_columns(cols: Columns, num_records: int, n_docs: int,
                  pad: int) -> tuple[PlacedStore, DeviceLayout]:
    """A store, from its columns on the device (rows of each record
    contiguous, in the store's order), as six int32 tensors there with
    ``pad`` sentinel rows each (a slice of up to ``pad`` rows from any row
    stays inside the tensor), and the rest of its query layout. Equal, array
    for array, to ``QueryLayout.build`` and to ``IntervalStore``'s record
    offsets and longest intervals; raises where the composite keys would
    overflow or a coordinate does not fit int32."""
    start, end, order = cols.start, cols.end, cols.order
    device = start.device
    n, R, C = start.numel(), num_records, n_docs
    with _stage("place.sort_gather", device):
        # memo_tpu's key stride (it must exceed every coordinate: ends reach
        # 2x a record's length); ``span`` also covers negative coordinates.
        hi = int(torch.maximum(start.max(), end.max())) if n else -1
        least = int(torch.minimum(start.min(), end.min())) if n else 0
        lo = min(least, 0)
        stride, span = hi + 2, hi + 2 - lo
        in_range = bool(((order >= 0) & (order < C)).all()) if n else True
        _check_keys_fit(R * C if in_range else R, span)
        _check_int32(least, hi)
        rec = cols.rec.to(torch.int64)
        # IntervalStore's record offsets and longest interval per record.
        rec_counts = torch.bincount(rec, minlength=R)[:R]
        rec_offsets = torch.zeros(R + 1, dtype=torch.int64, device=device)
        rec_offsets[1:] = torch.cumsum(rec_counts, 0)
        rec_offsets = rec_offsets.cpu().numpy()
        # Each record's rows are contiguous: a max over each nonempty slice.
        longest = torch.zeros(R, dtype=torch.int64, device=device)
        live = np.flatnonzero(np.diff(rec_offsets))
        if live.size:
            lengths = end - start
            longest[torch.from_numpy(live).to(device)] = torch.stack(
                [lengths[rec_offsets[r] : rec_offsets[r + 1]].amax() for r in live.tolist()])
            del lengths
        perm_e = torch.argsort(rec * span + (end - lo), stable=True)
        end_sorted, start_by_end, order_by_end = end[perm_e], start[perm_e], order[perm_e]
        del perm_e
        if in_range:
            seg = rec * C + order
            counts = torch.bincount(seg, minlength=R * C)
            perm_c = torch.argsort(seg * span + (start - lo), stable=True)
            seg = seg[perm_c]
            s_by_col, e_by_col = start[perm_c], end[perm_c]
            del perm_c
            # Ends must be nondecreasing within each (record, order) segment;
            # a segment's first row is exempt.
            monotone = bool(((e_by_col[1:] >= e_by_col[:-1]) | (seg[1:] != seg[:-1])).all())
            col_offsets = torch.zeros(R * C + 1, dtype=torch.int64, device=device)
            col_offsets[1:] = torch.cumsum(counts, 0)
            keys = (seg * stride + s_by_col, seg * stride + e_by_col) if n else None
            del seg, s_by_col, e_by_col
        else:  # a foreign store with orders outside [0, C): the scan path only
            monotone, keys = False, None
            col_offsets = torch.zeros(R * C + 1, dtype=torch.int64, device=device)
        del rec
        if keys is None:  # QueryLayout.build's stride and keys where it keeps none
            stride = 1
            keys = (torch.zeros(0, dtype=torch.int64, device=device),) * 2

    with _stage("place.pad", device):

        def padded(src: torch.Tensor, fill: int) -> torch.Tensor:
            out = torch.full((n + pad,), fill, dtype=torch.int32, device=device)
            out[:n] = src
            return out

        placed = PlacedStore(
            padded(start, 0),
            padded(end, 0),
            padded(order, -1),
            padded(end_sorted, 0),
            padded(start_by_end, 0),
            padded(order_by_end, -1),
        )
        del end_sorted, start_by_end, order_by_end

    layout = DeviceLayout(
        col_offsets=col_offsets,
        s_keys=keys[0],
        e_keys=keys[1],
        key_stride=stride,
        monotone=monotone,
        n_docs=C,
        rec_offsets=rec_offsets,
        longest=longest.cpu().numpy(),
        num_rows=n,
    )
    return placed, layout


def short_share(cols: Columns, below: int) -> float:
    """The share of rows shorter than ``below`` (memo_tpu's stratify gate,
    ``np.mean(end - start < below)``, to the same float)."""
    return int(((cols.end - cols.start) < below).sum()) / cols.start.numel()


def split_by_length(cols: Columns, edges) -> list[tuple[int, Columns]]:
    """The nonempty length buckets of the rows, on the device: bucket ``b``
    holds the rows whose ``end - start`` has ``b`` of ``edges`` at or below
    it (``np.searchsorted(edges, length, side="right")``), in store order."""
    device = cols.start.device
    with _stage("engine.bucket_split", device):
        length = cols.end - cols.start
        b_id = torch.zeros(length.shape, dtype=torch.int8, device=device)
        for edge in edges:
            b_id += length >= edge
        del length
        out = []
        for b in range(len(edges) + 1):
            rows = torch.nonzero(b_id == b).squeeze(1)
            if rows.numel():
                out.append((b, Columns(*(c[rows] for c in cols))))
    return out
