"""Device-resident interval store answering whole records, on one GPU.

Counterpart of :mod:`memo_tpu.parallel.resident` (its docstring proves the
placement exact). The store's rows are placed on the device once; every
query at a new (k, mode) is one dispatch that computes the whole record's
coverage from the resident rows, and every window is a slice of it. The
placement keeps only rows that can mark at some k <= k_max: an interval
marks only when its length < k - 1, so rows with length >= k_max - 1 are
dropped when the store is placed.

memo_tpu splits each record into ``sp`` coordinate slabs, one per device,
and with ``records=`` spreads the records over ``dp``. The port runs the
one-device layout (1 x 1) until its multi-GPU slice: one slab per record,
the records of a multi-record placement stacked as the window dimension of
``query_ops.coverage_counts``, so one dispatch still serves them all.
"""

from __future__ import annotations

import numpy as np
import torch

from memo_tpu_torch.ops.query_ops import (
    conservation_from_marks,
    coverage_marks,
    membership_from_marks,
)
from memo_tpu_torch.parallel.sharded import _round_up
from memo_tpu_torch.utils.device import resolve_device


class ResidentShardedQuery:
    """Arbitrary-k queries against a device-resident store.

    ``record=`` places one record, ``records=`` several in one placement
    (with neither, a one-record store places its record and a multi-record
    store all of them). Whole-record outputs are memoized per (k, mode) in
    a 4-entry LRU, so the windows of one (record, k) batch cost one
    dispatch (``dispatch_count`` counts them).
    """

    def __init__(
        self,
        store,
        device="cuda",
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
        self.device = resolve_device(device)
        self.n_dp, self.n_sp = 1, 1  # the one-device layout (see the module docstring)
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

        # Placement-time length filter (exact): rows with length >= k_max-1
        # never mark at any k this placement serves.
        all_rows = []  # [record][shard] -> index array into the store
        for name, r in zip(self.records, rec_idx):
            rec_end = int(store.rec_offsets[r + 1])
            rows_per_shard = []
            for d in range(n_sp):
                lo, hi = store.window_bounds(
                    name, d * self.B, min((d + 1) * self.B, self._rec_lens[name]), self.k_max
                )
                hi = min(hi, rec_end)
                idx = np.arange(lo, hi)
                if hi > lo:
                    ln = store.end[lo:hi] - store.start[lo:hi]
                    idx = idx[ln < self.k_max - 1]
                rows_per_shard.append(idx)
            all_rows.append(rows_per_shard)
        M = _round_up(max(1, max(len(ix) for b in all_rows for ix in b)), 8)
        if self._multi:
            self.n_batch = (len(self.records) + self.n_dp - 1) // self.n_dp
            shape = (self.n_batch, self.n_dp, n_sp, M)
        else:
            self.n_batch = 1
            shape = (n_sp, M)
        starts = np.zeros(shape, np.int32)
        ends = np.zeros(shape, np.int32)
        orders = np.full(shape, -1, np.int32)  # order<0 rows are dropped
        for i, rows_per_shard in enumerate(all_rows):
            slot = (i // self.n_dp, i % self.n_dp) if self._multi else ()
            for d, ix in enumerate(rows_per_shard):
                m = len(ix)
                starts[slot + (d, slice(0, m))] = store.start[ix]
                ends[slot + (d, slice(0, m))] = store.end[ix]
                orders[slot + (d, slice(0, m))] = store.order[ix]
        self.rows_per_shard = M
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
        """Whole-placement output [..., n_sp * B(, C)]: every (record, slab)
        row of the placement is one window of the coverage op, at qs = its
        slab's first position."""
        if not 1 <= k <= self.k_max:
            raise ValueError(f"k={k} outside this store's placement (k_max={self.k_max})")
        key = (int(k), bool(membership))
        hit = self._full_cache.pop(key, None)
        if hit is not None:
            self._full_cache[key] = hit  # refresh LRU position
            return hit
        lead = self._d_start.shape[:-2]
        M = self.rows_per_shard
        n_rows = self._d_start.numel() // M
        slab_qs = (torch.arange(n_rows, device=self.device) % self.n_sp) * self.B
        marks = coverage_marks(
            self._d_start.view(n_rows, M), self._d_end.view(n_rows, M),
            self._d_order.view(n_rows, M), slab_qs, k, L=self.B, C=self.n_docs,
        )
        if membership:
            out = membership_from_marks(marks)
        else:
            out = conservation_from_marks(marks, self.n_docs)
        out = out.reshape(lead + (self.n_sp * self.B,) + out.shape[2:])
        self.dispatch_count += 1
        if len(self._full_cache) >= self._full_cache_cap:
            self._full_cache.pop(next(iter(self._full_cache)))
        self._full_cache[key] = out
        return out
