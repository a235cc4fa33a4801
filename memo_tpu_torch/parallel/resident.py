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

A query at a new (k, mode) is one dispatch on every rank: the coverage of
its own slabs from its own rows (no halo: the k-1 shadow reach is in the row
ranges), then all-gathers over ``sp`` and ``dp`` into memo_tpu's layout
([n_batch, dp, sp*B(, C)], or [sp*B(, C)] for ``record=``), so every rank
holds every record's output. Every window is a slice of it.
"""

from __future__ import annotations

import numpy as np
import torch

from memo_tpu_torch.ops.query_ops import (
    conservation_from_marks,
    coverage_marks,
    membership_from_marks,
)
from memo_tpu_torch.parallel.sharded import _round_up, as_mesh


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
            if seg.stop > seg.start and int((store.end[seg] - store.start[seg]).min()) < 0:
                raise ValueError("store has end < start rows; cannot shard by coordinate")

        # Every rank finds every slab's rows on the host (binary searches), so
        # that the padded width M is memo_tpu's; it uploads only its own.
        all_rows = []  # [record][slab] -> index array into the store
        for name, r in zip(self.records, rec_idx):
            rec_end = int(store.rec_offsets[r + 1])
            rows_per_slab = []
            for s in range(n_sp):
                lo, hi = store.window_bounds(
                    name, s * self.B, min((s + 1) * self.B, self._rec_lens[name]), self.k_max
                )
                hi = min(hi, rec_end)
                idx = np.arange(lo, hi)
                if hi > lo:
                    ln = store.end[lo:hi] - store.start[lo:hi]
                    idx = idx[ln < self.k_max - 1]  # exact: these rows never mark
                rows_per_slab.append(idx)
            all_rows.append(rows_per_slab)
        M = _round_up(max(1, max(len(ix) for b in all_rows for ix in b)), 8)
        self.rows_per_shard = M
        d, s = self.mesh.coord("dp"), self.mesh.coord("sp")
        self._s = s
        if self._multi:
            self.n_batch = (len(self.records) + self.n_dp - 1) // self.n_dp
            mine = [all_rows[i][s] if i < len(all_rows) else np.arange(0)
                    for i in range(d, self.n_batch * self.n_dp, self.n_dp)]
        else:
            self.n_batch = 1
            mine = [all_rows[0][s]]
        self.local_rows = sum(len(ix) for ix in mine)  # store rows this rank holds
        starts = np.zeros((len(mine), M), np.int32)
        ends = np.zeros((len(mine), M), np.int32)
        orders = np.full((len(mine), M), -1, np.int32)  # order<0 rows are dropped
        for b, ix in enumerate(mine):
            starts[b, :len(ix)] = store.start[ix]
            ends[b, :len(ix)] = store.end[ix]
            orders[b, :len(ix)] = store.order[ix]
        self._d_start, self._d_end, self._d_order = (
            torch.from_numpy(a).to(self.device) for a in (starts, ends, orders)
        )
        # Whole-record outputs memoized per (k, mode); a bounded LRU, so a k
        # sweep cannot accumulate stale device memory.
        self._full_cache: dict[tuple[int, bool], torch.Tensor] = {}
        self._full_cache_cap = 4
        self.dispatch_count = 0  # == number of distinct (k, mode) computed

    def stats(self) -> dict:
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
        this rank's [n_batch, B(, C)] slab outputs (each row of its placement
        is one window of the coverage op, at qs = the slab's first position),
        all-gathered over sp, then over dp."""
        if not 1 <= k <= self.k_max:
            raise ValueError(f"k={k} outside this store's placement (k_max={self.k_max})")
        key = (int(k), bool(membership))
        hit = self._full_cache.pop(key, None)
        if hit is not None:
            self._full_cache[key] = hit  # refresh LRU position
            return hit
        marks = coverage_marks(self._d_start, self._d_end, self._d_order, self._s * self.B, k,
                               L=self.B, C=self.n_docs)
        if membership:
            out = membership_from_marks(marks)
        else:
            out = conservation_from_marks(marks, self.n_docs)
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
