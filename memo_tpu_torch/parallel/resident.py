"""Device-resident, coordinate-sharded interval store answering whole records.

Counterpart of :mod:`memo_tpu.parallel.resident` (its docstring proves the
placement exact). Each record's coordinate axis is split into ``sp`` slabs
of B positions; with ``records=``, record i goes to dp slot ``i % dp`` (batch
slot ``i // dp``), so the ``dp`` axis serves distinct records. Rank (d, s) of
the mesh places, once, only the rows of slab s of the records in its dp
slot: the rows ``window_bounds(s*B, (s+1)*B, k_max)``, less those with
length >= k_max - 1, which never mark at any k this placement serves. So
each device holds about 1/(dp*sp) of the index. With ``record=`` every dp
rank holds slab s of the one record, as memo_tpu replicates it over dp.

Where memo_tpu computes a slab's coverage with the diff-array program, each
rank here uploads its slabs' rows (from a loaded store's file, only those
rows, with no host copy of a column; ``index/placement.py``), checks them,
drops the long ones on the device and holds the rest as a
:class:`~memo_tpu_torch.query.engine.QueryEngine` on the fused backend
(placed once, its length buckets and query layout built on the device).
It answers a slab as windows of at most
``chunk_positions`` of one record: one launch of the fused kernel per
length bucket for the whole slab, whose [windows, L(, C)] output, read as
consecutive positions, is the slab. The device's work is the placed rows
and the output; no [B, C] count plane is built. The slab's positions past
its record's end hold the unmarked value and are sliced off before any
caller sees them.

A query at a new (k, mode) is one dispatch on every rank: its own slabs
from its own rows (no halo: the k-1 shadow reach is in the row ranges),
then all-gathers over ``sp`` and ``dp`` into memo_tpu's layout
([n_batch, dp, sp*B(, C)], or [sp*B(, C)] for ``record=``), so every rank
holds every record's output. Every window is a slice of it; a call's
windows come to the host together, in one copy.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from memo_tpu_torch.index.placement import Columns, start_rows, upload_columns
from memo_tpu_torch.index.store import IntervalStore
from memo_tpu_torch.parallel.sharded import _round_up, as_mesh
from memo_tpu_torch.query import engine as engine_mod
from memo_tpu_torch.query.engine import QueryEngine

class _RowsEngine(QueryEngine):
    """The fused engine over the rows that ``rows()`` returns (on the
    device, in store order); its outputs are left on the device."""

    def __init__(self, store: IntervalStore, rows, device):
        self._rows = rows
        super().__init__(store, backend="fused", device_output=True, device=device)

    def _upload(self, store: IntervalStore) -> Columns:
        """The rows, streamed, checked and filtered by
        :meth:`ResidentShardedQuery._rows` when asked for, so that only the
        engine's set-up holds them (the stratified set-up drops them once
        split into buckets)."""
        rows, self._rows = self._rows, None
        return rows()


class ResidentShardedQuery:
    """Arbitrary-k queries against a coordinate-sharded device-resident store.

    ``mesh`` is a :class:`~memo_tpu_torch.parallel.sharded.Mesh`, None
    (``make_mesh``'s default) or a device for the 1 x 1 layout on it.
    ``record=`` places one record, ``records=`` several in one placement
    (with neither, a one-record store places its record and a multi-record
    store all of them). Whole-record outputs are memoized per (k, mode) in
    a 4-entry LRU, so the windows of one (record, k) batch cost one
    dispatch (``dispatch_count`` counts them). Every rank must make the same
    calls in the same order: each dispatch ends in collectives.
    """

    def __init__(
        self,
        store,
        mesh=None,
        record: str | None = None,
        k_max: int = 1024,
        device_output: bool = False,
        records: list[str] | None = None,
    ):
        if store.kind not in ("conservation", "membership"):
            raise ValueError(f"bad store kind {store.kind!r}")
        if records is not None and record is not None:
            raise ValueError("pass record= or records=, not both")
        if records is None and record is None:
            if store.num_records == 1:
                record = store.record_names[0]
            else:
                records = list(store.record_names)
        self.store = store
        self.mesh = as_mesh(mesh)
        self.device = self.mesh.device
        self.n_dp, self.n_sp = self.mesh.dp, self.mesh.sp
        self.k_max = int(k_max)
        self.n_docs = store.n_docs
        self.device_output = bool(device_output)

        self._multi = records is not None
        self.records = list(records) if self._multi else [record]
        self.record = self.records[0]
        self._slot = {name: i for i, name in enumerate(self.records)}
        if len(self._slot) != len(self.records):
            raise ValueError("duplicate records in placement")
        rec_idx = [store.record_index(name) for name in self.records]
        self._rec_lens = {name: int(store.record_lens[r]) for name, r in zip(self.records, rec_idx)}
        self.record_len = self._rec_lens[self.record]
        n_sp = self.n_sp
        self.B = _round_up(max(max(self._rec_lens.values()), 1), n_sp) // n_sp

        d, s = self.mesh.coord("dp"), self.mesh.coord("sp")
        self._s = s
        if self._multi:
            self.n_batch = (len(self.records) + self.n_dp - 1) // self.n_dp
            # This rank's batch slots: records d, d + dp, ...; None for an empty slot.
            self._mine = [self.records[i] if i < len(self.records) else None
                          for i in range(d, self.n_batch * self.n_dp, self.n_dp)]
        else:
            self.n_batch = 1
            self._mine = [self.records[0]]
        mine = sorted(store.record_index(name) for name in self._mine if name is not None)
        self.engine = _RowsEngine(store, functools.partial(self._rows, mine, s), self.device)
        self.local_rows = sum(c._layout.num_rows for c in self._placed())  # store rows held here
        # Whole-record outputs memoized per (k, mode); a bounded LRU, so a k
        # sweep cannot accumulate stale device memory.
        self._full_cache: dict[tuple[int, bool], torch.Tensor] = {}
        self._full_cache_cap = 4
        self.dispatch_count = 0  # == number of distinct (k, mode) computed

    def _bounds(self, recs: list[int], slab: int) -> dict[int, tuple[int, int, int, int]]:
        """For each record r of ``recs``: the store rows [lo, hi) that slab
        ``slab`` of r may read, those whose coordinates reach it at any k <=
        k_max (``IntervalStore.window_bounds(s*B, (s+1)*B, k_max)`` clipped
        to the record), and the rows [c_lo, c_hi) whose end >= start this
        rank checks: record r's rows cut at each slab's ``lo`` (the first
        slab's from the record's first row, the last slab's to its last),
        so that the slabs of all ranks check each row of r once. Found
        without the host start column (:func:`start_rows`)."""
        store, B, k_max = self.store, self.B, self.k_max
        values = {}
        for r in recs:
            longest, length = int(store.max_interval_len[r]), int(store.record_lens[r])
            values[r] = [slab * B - longest, min((slab + 1) * B, length) + k_max]
            if slab + 1 < self.n_sp:  # the next slab's lo: where this rank's check ends
                values[r].append((slab + 1) * B - longest)
        found = start_rows(store, values, self.device)
        out = {}
        for r in recs:
            rec_lo, rec_hi = int(store.rec_offsets[r]), int(store.rec_offsets[r + 1])
            lo, hi, *nxt = found[r]
            out[r] = (lo, max(min(hi, rec_hi), lo), rec_lo if slab == 0 else lo,
                      nxt[0] if nxt else rec_hi)
        return out

    def _rows(self, recs: list[int], slab: int) -> Columns:
        """Slab ``slab``'s rows of the records ``recs`` on the device, less
        those of length >= k_max - 1, which never mark at any k <= k_max.
        Each record's rows that this rank reads or checks (:meth:`_bounds`)
        are uploaded once (``upload_columns``: from a loaded store's file,
        those rows only); the end >= start verdict, which the exactness
        argument needs and every MEM-overlap store meets, is taken over the
        mesh, so that every rank raises before any dispatch where any row
        fails it. The most rows that any rank keeps for one slab of one
        record goes over the mesh with the verdict (``rows_per_shard``)."""
        bounds = self._bounds(recs, slab)
        # The rows read for each record: its check rows and its slab rows.
        spans = [(min(lo, c_lo), max(hi, c_hi)) for lo, hi, c_lo, c_hi in bounds.values()]
        cols = upload_columns(self.store, self.device, spans)
        bad = torch.zeros((), dtype=torch.bool, device=self.device)
        keep, at = [], 0
        for (lo, hi, c_lo, c_hi), (a, b) in zip(bounds.values(), spans):
            bad |= (cols.end[at + c_lo - a : at + c_hi - a]
                    < cols.start[at + c_lo - a : at + c_hi - a]).any()
            keep.append((at + lo - a, at + hi - a))
            at += b - a
        if any((lo, hi) != span for (lo, hi, _, _), span in zip(bounds.values(), spans)):
            cols = Columns(*(torch.cat([c[a:b] for a, b in keep]) for c in cols))
        short = (cols.end - cols.start) < self.k_max - 1
        # Rows kept for each record's slab (its rows are consecutive in cols).
        edges = np.cumsum([0] + [b - a for a, b in keep]).tolist()
        widest = torch.zeros((), dtype=torch.int64, device=self.device)
        for a, b in zip(edges[:-1], edges[1:]):
            widest = torch.maximum(widest, short[a:b].sum())
        mine = torch.stack([bad.to(torch.int64), widest])
        both = self.mesh.all_gather(self.mesh.all_gather(mine, "sp"), "dp").reshape(-1, 2)
        any_bad, self._widest = both.amax(0).tolist()
        if any_bad:  # a row of any rank's
            raise ValueError("store has end < start rows; cannot shard by coordinate")
        return Columns(*(c[short] for c in cols))

    def _placed(self) -> list[QueryEngine]:
        """The engines that hold this rank's rows: one per length bucket, or
        the engine itself."""
        return [c for _, c in self.engine._children or [(0, self.engine)]]

    @functools.cached_property
    def rows_per_shard(self) -> int:
        """memo_tpu's padded row width M: the most rows any rank keeps for
        one slab of one record, rounded up to 8. Nominal here (the ranks
        place their rows in the engine's buckets, not in an [n_batch, M]
        array); each rank counts its own on the device at set-up and
        :meth:`_rows` takes the most over the mesh, so no host column is
        read. ``stats()`` reports it."""
        return _round_up(max(1, self._widest), 8)

    def stats(self) -> dict:
        """memo_tpu's keys (``resident_bytes_per_shard`` is its nominal
        rows_per_shard * 12 * n_batch), and the port's own: the rows this
        rank holds and the bytes of their placement on the device, rows and
        query layout."""
        placed = [(*c._d, *c._layout.device_tensors()) for c in self._placed()]
        return {
            "record": self.record,
            "records": self.records,
            "record_len": self.record_len,
            "shards": self.n_sp,
            "dp_slots": self.n_dp * self.n_batch if self._multi else 1,
            "slab_positions": self.B,
            "rows_per_shard": self.rows_per_shard,
            "resident_bytes_per_shard": self.rows_per_shard * 12 * self.n_batch,
            "local_rows": self.local_rows,
            "placed_bytes": sum(t.numel() * t.element_size() for d in placed for t in d),
            "k_max": self.k_max,
        }

    def _pick(self, record: str | None) -> str:
        if record is None:
            if len(self.records) > 1:
                raise ValueError("multi-record placement: pass record=")
            return self.record
        if record not in self._slot:
            raise KeyError(f"record {record!r} not in this placement")
        return record

    # ------------------------------------------------------------------ public
    def conservation_full(self, k: int, record: str | None = None) -> torch.Tensor:
        """int32[record_len] conservation of the whole record (on the device),
        sliced out of the one dispatch that served every record."""
        return self._record_out(k, record, membership=False)

    def membership_full(self, k: int, record: str | None = None) -> torch.Tensor:
        """int8[record_len, n] membership of the whole record (on the device)."""
        return self._record_out(k, record, membership=True)

    def conservation(self, qs: int, qe: int, k: int, record: str | None = None):
        out = self.conservation_full(k, record)[qs:qe]
        return out if self.device_output else out.cpu().numpy()

    def membership(self, qs: int, qe: int, k: int, record: str | None = None):
        out = self.membership_full(k, record)[qs:qe]
        return out if self.device_output else out.cpu().numpy()

    def conservation_windows(self, windows, k: int, record: str | None = None):
        """Windows of one record, all served by one whole-record dispatch per
        k; on the host, all of them come back in one copy and one wait."""
        return self._windows(self.conservation_full(k, record), windows)

    def membership_windows(self, windows, k: int, record: str | None = None):
        """Membership twin of :meth:`conservation_windows`."""
        return self._windows(self.membership_full(k, record), windows)

    # ---------------------------------------------------------------- internals
    def _windows(self, full: torch.Tensor, windows) -> list:
        """The slices ``windows`` of ``full``: left on the device, or on the
        host as views of one buffer, filled from the device by one copy
        (pinned memory on CUDA) and one wait."""
        outs = [full[qs:qe] for qs, qe in windows]
        if self.device_output or not outs:
            return outs
        host, ready = engine_mod._copy_back(torch.cat(outs))
        if ready is not None:
            ready.synchronize()
        return np.split(host.numpy(), np.cumsum([len(o) for o in outs[:-1]], dtype=np.int64))

    def _record_out(self, k: int, record: str | None, membership: bool) -> torch.Tensor:
        record = self._pick(record)
        out = self._full(k, membership)
        if self._multi:
            i = self._slot[record]
            out = out[i // self.n_dp, i % self.n_dp]
        return out[: self._rec_lens[record]]

    def _full(self, k: int, membership: bool) -> torch.Tensor:
        """Whole-placement output, [n_batch, dp, sp*B(, C)] or [sp*B(, C)]:
        this rank's [n_batch, B(, C)] slab outputs (:meth:`_slabs`),
        all-gathered over sp, then over dp."""
        if not 1 <= k <= self.k_max:
            raise ValueError(f"k={k} outside this store's placement (k_max={self.k_max})")
        key = (int(k), bool(membership))
        hit = self._full_cache.pop(key, None)
        if hit is not None:
            self._full_cache[key] = hit  # refresh LRU position
            return hit
        out = self._slabs(k, membership)
        tail = tuple(out.shape[2:])
        out = self.mesh.all_gather(out, "sp").transpose(0, 1)  # [n_batch, sp, B(, C)]
        out = out.reshape((self.n_batch, self.n_sp * self.B) + tail)
        if self._multi:
            out = self.mesh.all_gather(out, "dp").transpose(0, 1).contiguous()
        else:
            out = out[0]
        self.dispatch_count += 1
        if len(self._full_cache) >= self._full_cache_cap:
            self._full_cache.pop(next(iter(self._full_cache)))
        self._full_cache[key] = out
        return out

    def _slabs(self, k: int, membership: bool) -> torch.Tensor:
        """This rank's [n_batch, B(, C)] slab outputs (:meth:`_slab`)."""
        slabs = [self._slab(name, k, membership) for name in self._mine]
        return slabs[0][None] if len(slabs) == 1 else torch.stack(slabs)

    def _slab(self, name: str | None, k: int, membership: bool) -> torch.Tensor:
        """Positions [s*B, (s+1)*B) of record ``name``, [B(, C)]: the
        engine's batch of windows of at most ``chunk_positions`` (one launch
        per length bucket), read as consecutive positions. Positions past
        the record's end, and an empty slot (None), hold the unmarked value
        (conservation n_docs, membership 1)."""
        eng, B = self.engine, self.B
        lo = self._s * B
        hi = min(lo + B, self._rec_lens[name]) if name is not None else lo
        step = eng.chunk_positions
        windows = [(qs, min(qs + step, hi)) for qs in range(lo, hi, step)]
        if windows:  # one launch per bucket, whatever the windows' candidate counts
            out = eng._batch_tensor(name, windows, k, membership).flatten(0, 1)
        else:
            out = eng._unmarked((0,), membership)
        if out.shape[0] < B:
            out = torch.cat([out, eng._unmarked((B - out.shape[0],), membership)])
        out = out[:B]
        out[hi - lo :] = 1 if membership else self.n_docs
        return out
