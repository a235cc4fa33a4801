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
rank here uploads its slabs' rows, drops the long ones on the device and
holds the rest as a :class:`~memo_tpu_torch.query.engine.QueryEngine` on
the fused backend (placed once, its length buckets and query layout built
on the device). It answers a slab as windows of at most
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
holds every record's output. Every window is a slice of it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from memo_tpu_torch.index.placement import Columns
from memo_tpu_torch.index.store import IntervalStore
from memo_tpu_torch.parallel.sharded import _round_up, as_mesh
from memo_tpu_torch.query.engine import QueryEngine


class _RowsEngine(QueryEngine):
    """The fused engine over the store rows ``parts`` ([lo, hi) ranges in
    store order) less those of length >= k_max - 1, which never mark at
    any k <= k_max; its outputs are left on the device."""

    def __init__(self, store: IntervalStore, parts: list[tuple[int, int]], k_max: int, device):
        self._parts, self._k_max = parts, k_max
        super().__init__(store, backend="fused", device_output=True, device=device)

    def _upload(self, store: IntervalStore) -> Columns:
        """The rows, uploaded as slices of the store's columns and filtered
        on the device; only the engine's set-up holds them."""
        def upload(a: np.ndarray) -> torch.Tensor:
            got = [torch.from_numpy(a[lo:hi]).to(self.device) for lo, hi in self._parts or [(0, 0)]]
            return got[0] if len(got) == 1 else torch.cat(got)

        cols = Columns(upload(store.rec_id), upload(store.start), upload(store.end),
                       upload(store.order))
        keep = (cols.end - cols.start) < self._k_max - 1
        return Columns(*(c[keep] for c in cols))


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

        # The exactness argument needs end >= start, which every MEM-overlap
        # store satisfies.
        for r in rec_idx:
            seg = slice(int(store.rec_offsets[r]), int(store.rec_offsets[r + 1]))
            if (store.end[seg] < store.start[seg]).any():
                raise ValueError("store has end < start rows; cannot shard by coordinate")

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
        self.engine = _RowsEngine(store, [self._slab_rows(r, s) for r in mine], self.k_max,
                                  self.device)
        self.local_rows = sum(c._layout.num_rows for c in self._placed())  # store rows held here
        # Whole-record outputs memoized per (k, mode); a bounded LRU, so a k
        # sweep cannot accumulate stale device memory.
        self._full_cache: dict[tuple[int, bool], torch.Tensor] = {}
        self._full_cache_cap = 4
        self.dispatch_count = 0  # == number of distinct (k, mode) computed

    def _slab_rows(self, r: int, slab: int) -> tuple[int, int]:
        """Store rows [lo, hi) that slab ``slab`` of record ``r`` may read:
        those whose coordinates reach it at any k <= k_max."""
        store, name = self.store, self.store.record_names[r]
        lo, hi = store.window_bounds(
            name, slab * self.B, min((slab + 1) * self.B, int(store.record_lens[r])), self.k_max)
        return lo, max(min(hi, int(store.rec_offsets[r + 1])), lo)

    def _placed(self) -> list[QueryEngine]:
        """The engines that hold this rank's rows: one per length bucket, or
        the engine itself."""
        return [c for _, c in self.engine._children or [(0, self.engine)]]

    @functools.cached_property
    def rows_per_shard(self) -> int:
        """memo_tpu's padded row width M: the most rows any rank keeps for
        one slab, rounded up to 8. Nominal here (the ranks place their rows
        in the engine's buckets, not in an [n_batch, M] array); computed on
        first use, from every slab's rows on the host."""
        widest = 0
        for name in self.records:
            r = self.store.record_index(name)
            for slab in range(self.n_sp):
                lo, hi = self._slab_rows(r, slab)
                lengths = self.store.end[lo:hi] - self.store.start[lo:hi]
                widest = max(widest, int(np.count_nonzero(lengths < self.k_max - 1)))
        return _round_up(max(1, widest), 8)

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
        """Windows of one record, all served by one whole-record dispatch per k."""
        full = self.conservation_full(k, record)
        outs = [full[qs:qe] for qs, qe in windows]
        return outs if self.device_output else [o.cpu().numpy() for o in outs]

    def membership_windows(self, windows, k: int, record: str | None = None):
        """Membership twin of :meth:`conservation_windows`."""
        full = self.membership_full(k, record)
        outs = [full[qs:qe] for qs, qe in windows]
        return outs if self.device_output else [o.cpu().numpy() for o in outs]

    # ---------------------------------------------------------------- internals
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
        out = eng._batch_tensor(name, windows, k, membership) if windows else None
        if out is not None:
            out = out.reshape((-1,) + tuple(out.shape[2:]))
        elif windows:  # a window's candidates over the engine's cap: per window
            out = torch.cat(eng._query_batch_windows(name, windows, k, membership))
        else:
            out = eng._unmarked((0,), membership)
        if out.shape[0] < B:
            out = torch.cat([out, eng._unmarked((B - out.shape[0],), membership)])
        out = out[:B]
        out[hi - lo :] = 1 if membership else self.n_docs
        return out
