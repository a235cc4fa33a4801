"""Batched window queries over a (dp, sp) mesh, candidates gathered on the device.

Counterpart of :mod:`memo_tpu.parallel.sharded`. memo_tpu runs a batch of
windows SPMD over a ``jax.sharding.Mesh`` from one controller, which finds
and gathers every window's candidate rows on the host; the port uses
torch's multi-controller idiom instead: one process per device, all in one
``torch.distributed`` process group (NCCL on GPUs, gloo on the CPU), each
running this same code on the same store and calling the same collectives
in the same order. Each rank places the store's start, end and order
columns on its device once (a loaded store's streamed from its file, with
no host copy), and finds and gathers each window's rows there. The mesh
axes shard what memo_tpu's do:

- ``dp``: the windows of each candidate bucket (padded to a multiple of dp
  with a repeat row); rank (d, s) takes windows [d*W/dp, (d+1)*W/dp).
- ``sp``, one of two exact strategies:

  * ``position``: the candidate set is replicated and rank s computes the
    positions [s*L/sp, (s+1)*L/sp) of each window (the k-1 shadow reach is
    folded into the stored intervals, so slabs need no halo);
  * ``interval``: rank s takes candidate columns [s*M/sp, (s+1)*M/sp) and
    builds int32 partial counts for the whole window; one
    ``reduce_scatter_tensor`` over the ``sp`` group sums them into its own
    L/sp slab of positions (memo_tpu's ``psum_scatter``), which it reduces.

Every rank's slab outputs are then all-gathered over ``sp`` and then over
``dp``, so every rank returns the whole batch, as memo_tpu's controller does.

Without a process group the one-device layout (1 x 1) runs in process, with
no collective. Any other layout needs one rank per device:
``torchrun --nproc-per-node N`` (or :func:`memo_tpu_torch.parallel.initialize`).
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch
import torch.distributed as dist

from memo_tpu_torch.index.placement import I32, _check_int32, _stage, upload_columns
from memo_tpu_torch.ops import query_ops as Q
from memo_tpu_torch.query import engine as engine_mod
from memo_tpu_torch.query.engine import _next_pow2
from memo_tpu_torch.utils.device import resolve_device

STRATEGIES = ("position", "interval")
BACKEND_DEVICE = {"nccl": "cuda", "gloo": "cpu"}  # the device type each backend serves
LAUNCH_HINT = (
    "one process per device: launch under `torchrun --nproc-per-node N` (or call "
    "memo_tpu_torch.parallel.initialize) with N = dp*sp"
)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (dp, sp) layout of ranks and this rank's device. ``device_mesh`` is
    the process group's ``DeviceMesh``, or None for the one-device layout
    run in process (no group, no collective)."""

    dp: int
    sp: int
    device: torch.device
    device_mesh: object = None

    @property
    def shape(self) -> dict[str, int]:
        return {"dp": self.dp, "sp": self.sp}

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return 0 if self.device_mesh is None else self.device_mesh.get_local_rank(axis)

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """[n, *x.shape]: ``x`` of every rank along ``axis``, in rank order."""
        if self.device_mesh is None:
            return x[None]
        n = self.shape[axis]
        # Concatenated along dim 0 (gloo accepts only that form; NCCL both).
        out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        with warnings.catch_warnings():  # newer torch renames it; older ones lack the new name
            warnings.simplefilter("ignore", FutureWarning)
            dist.all_gather_into_tensor(out, x.contiguous(), group=self.device_mesh.get_group(axis))
        return out.view((n,) + tuple(x.shape))

    def reduce_scatter(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of ``x`` over the ranks along ``axis``, split along dim 0:
        this rank keeps rows [i*R/n, (i+1)*R/n) for its index i."""
        if self.device_mesh is None:
            return x
        n = self.shape[axis]
        out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            dist.reduce_scatter_tensor(out, x.contiguous(), op=dist.ReduceOp.SUM,
                                       group=self.device_mesh.get_group(axis))
        return out


def check_layout(mesh) -> tuple[int, int]:
    """(dp, sp) of a requested layout, checked against the process group:
    without one only (1, 1) runs (in process); under one, dp*sp must be its
    world size. Anything else raises and says how to launch."""
    dp, sp = (int(x) for x in mesh)
    if dp < 1 or sp < 1:
        raise ValueError(f"mesh {dp}x{sp}: both sizes must be >= 1")
    if not dist.is_initialized():
        if (dp, sp) != (1, 1):
            raise ValueError(f"mesh {dp}x{sp} needs {dp * sp} ranks and no process group exists; "
                             + LAUNCH_HINT)
        return dp, sp
    world = dist.get_world_size()
    if dp * sp != world:
        raise ValueError(f"mesh {dp}x{sp} != {world} ranks in the process group")
    return dp, sp


def make_mesh(dp: int | None = None, sp: int | None = None, device_type: str = "cuda") -> Mesh:
    """A ('dp', 'sp') mesh over the ranks of the process group (memo_tpu's
    ``make_mesh`` over devices): by default every rank on ``sp``. Rank r sits
    at (r // sp, r % sp). Under NCCL each rank's device is the CUDA device
    :func:`initialize` set, under gloo the CPU; ``device_type`` must match
    the backend (nothing swaps one for the other). Without a group this is
    the in-process 1 x 1 layout on ``device_type``."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if dp is None and sp is None:
        dp, sp = 1, n
    elif dp is None:
        dp = n // sp
    elif sp is None:
        sp = n // dp
    dp, sp = check_layout((dp, sp))
    if not dist.is_initialized():
        return Mesh(dp, sp, resolve_device(device_type))
    from torch.distributed.device_mesh import init_device_mesh

    backend = dist.get_backend()
    if BACKEND_DEVICE.get(backend) != torch.device(device_type).type:
        raise ValueError(f"the process group's backend {backend!r} does not serve device "
                         f"{device_type!r}: initialize the group for that device")
    if backend == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    device_mesh = init_device_mesh(device.type, (dp, sp), mesh_dim_names=("dp", "sp"))
    return Mesh(dp, sp, device, device_mesh)


def as_mesh(mesh) -> Mesh:
    """``mesh`` itself, :func:`make_mesh`'s default for None, or for a device
    ("cuda", "cpu" or a ``torch.device``) the 1 x 1 layout on it."""
    if isinstance(mesh, Mesh):
        return mesh
    if mesh is None:
        return make_mesh()
    return make_mesh(1, 1, device_type=torch.device(mesh).type)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _reduce(marks: torch.Tensor, membership: bool, n_docs: int) -> torch.Tensor:
    if membership:
        return Q.membership_from_marks(marks)
    return Q.conservation_from_marks(marks, n_docs)


def conservation_batch(mesh: Mesh, starts, ends, orders, qs, k, *, L, n_docs,
                       strategy="position"):
    """int32[W_loc, L/sp]: this rank's slab of the conservation of its own
    windows. ``starts/ends/orders`` are this rank's candidate rows: [W_loc, M]
    for ``position``, its [W_loc, M/sp] columns for ``interval``; ``qs``
    the W_loc window starts; L a multiple of sp."""
    return _slab(mesh, starts, ends, orders, qs, k, L, n_docs, False, strategy)


def membership_batch(mesh: Mesh, starts, ends, orders, qs, k, *, L, n_docs,
                     strategy="position"):
    """int8[W_loc, L/sp, n_docs]: the membership twin of :func:`conservation_batch`."""
    return _slab(mesh, starts, ends, orders, qs, k, L, n_docs, True, strategy)


def _slab(mesh, starts, ends, orders, qs, k, L, C, membership, strategy):
    n_sp = mesh.sp
    if L % n_sp:
        raise ValueError(f"window length {L} not divisible by sp={n_sp}")
    L_loc = L // n_sp
    qs = torch.as_tensor(qs, dtype=torch.int64, device=starts.device)
    if strategy == "position":
        base = qs + mesh.coord("sp") * L_loc
        marks = Q.coverage_marks(starts, ends, orders, base, k, L=L_loc, C=C)
    elif strategy == "interval":
        part = Q.coverage_counts(starts, ends, orders, qs, k, L=L, C=C)  # [W_loc, L, C]
        # reduce_scatter_tensor splits along dim 0, so positions go first.
        slab = mesh.reduce_scatter(part.transpose(0, 1), "sp")  # [L/sp, W_loc, C], summed
        marks = slab.transpose(0, 1) > 0
    else:
        raise ValueError(f"unknown strategy {strategy!r}")
    return _reduce(marks, membership, C)


class ShardedQuery:
    """Batched queries over an :class:`IntervalStore` on a (dp, sp) mesh.

    ``mesh`` is a :class:`Mesh`, None (:func:`make_mesh`'s default) or a
    device for the 1 x 1 layout on it. At construction each rank places the
    store's start, end and order columns on its device, int32 in store
    order, with one pad row after them (start 0, end 0, order -1; stage
    ``sharded.place``): a loaded store's straight from its file
    (``index/placement.upload_columns``), so no column is read on the host,
    which keeps only the R-sized record offsets and longest intervals.

    A call finds each window's candidate rows on the device
    (``IntervalStore.window_bounds``'s searches), brings the row ranges back
    in one copy to bucket the windows by pow2 candidate count, gathers each
    bucket's rows on the device (past a window's last row, the pad row, as
    memo_tpu pads) and computes its windows on the mesh. Every bucket's
    output stays on the device until the end of the call, when all of them
    come to the host in one copy and one wait. Every rank returns every
    window's output; results are bit-identical to the single-window engine.
    """

    def __init__(self, store, mesh=None, strategy: str = "position"):
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r}")
        self.store = store
        self.mesh = as_mesh(mesh)
        self.device = self.mesh.device
        self.strategy = strategy
        self.dp, self.sp = self.mesh.dp, self.mesh.sp
        self.n_docs = store.n_docs
        self._start, self._end, self._order = self._place(store)

    def _place(self, store) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The start, end and order columns on the device, int32[n + 1]
        each, row n the pad row; raises where a coordinate does not fit
        int32."""
        device = self.device
        with _stage("sharded.place", device):
            cols = upload_columns(store, device, names=("start", "end", "order"))
            n = cols.start.numel()
            if n:
                _check_int32(int(torch.minimum(cols.start.min(), cols.end.min())),
                             int(torch.maximum(cols.start.max(), cols.end.max())))
            placed = []
            for col, pad in ((cols.start, 0), (cols.end, 0), (cols.order, -1)):
                out = torch.full((n + 1,), pad, dtype=torch.int32, device=device)
                out[:n] = col
                placed.append(out)
            del cols
        return tuple(placed)

    def _window_rows(self, windows: list[tuple[str, int, int]], k: int):
        """Candidate rows (lo, hi) per (record, qs, qe) window, on the host
        (memo_tpu's list of pairs): ``window_bounds``'s two searches (``qs -
        max_interval_len`` and ``qe + k``, side left) in the record's start
        rows, on the device, all windows of a record in one call. A search
        in the record's own rows never passes its end, so hi is clipped to
        it. One copy up of the values, one copy back of the rows."""
        st, W = self.store, len(windows)
        recs = np.array([st.record_index(record) for record, _, _ in windows], np.int64)
        qs = np.array([w[1] for w in windows], np.int64)
        qe = np.array([w[2] for w in windows], np.int64)
        perm = np.argsort(recs, kind="stable")  # each record's windows together
        values = np.stack([qs - st.max_interval_len[recs], qe + k])[:, perm]  # [2, W]
        v = torch.from_numpy(values).to(self.device)
        # The start rows are int32: search int32 values (no copy of the rows
        # to a wider type); a value past int32 is past every row.
        past = v > I32.max
        v32 = v.clamp(I32.min, I32.max).to(torch.int32)
        found = torch.empty((2, W), dtype=torch.int64, device=self.device)
        cuts = np.flatnonzero(np.diff(recs[perm])) + 1
        for a, b in zip([0, *cuts.tolist()], [*cuts.tolist(), W]):
            r = int(recs[perm[a]])
            lo0, hi0 = int(st.rec_offsets[r]), int(st.rec_offsets[r + 1])
            at = torch.searchsorted(self._start[lo0:hi0], v32[:, a:b].contiguous(), side="left")
            found[:, a:b] = lo0 + torch.where(past[:, a:b], hi0 - lo0, at)
        rows = np.empty((2, W), np.int64)
        rows[:, perm] = found.cpu().numpy()
        return list(zip(*rows.tolist()))

    def _gather(self, lo: np.ndarray, hi: np.ndarray, M: int, col0: int = 0):
        """Columns [col0, col0 + M) of the candidate rows [lo, hi) of each
        window, as [W, M] int32 tensors on the device; a position at or past
        hi reads the pad row (start 0, end 0, order -1: dropped)."""
        bounds = torch.from_numpy(np.stack([lo, hi])).to(self.device)
        rows = bounds[0, :, None] + (col0 + torch.arange(M, dtype=torch.int64, device=self.device))
        rows = torch.where(rows < bounds[1, :, None], rows, self._start.numel() - 1)
        return self._start[rows], self._end[rows], self._order[rows]

    def _run(self, windows, k: int, membership: bool):
        if not windows:
            return []
        mesh = self.mesh
        d, s = mesh.coord("dp"), mesh.coord("sp")
        lens = [qe - qs for _, qs, qe in windows]
        L = _round_up(max(max(lens), 1), self.sp)
        lo, hi = np.array(self._window_rows(windows, k), np.int64).reshape(-1, 2).T
        # Bucket windows by next-pow2 candidate count, so that one dense
        # window does not inflate every window's padding to the batch max.
        buckets: dict[int, list[int]] = {}
        for i, m in enumerate((hi - lo).tolist()):
            M = _round_up(max(_next_pow2(m), self.sp), self.sp)
            buckets.setdefault(M, []).append(i)
        fn = membership_batch if membership else conservation_batch
        outs, order = [], []
        for M, idxs in sorted(buckets.items()):  # the same order on every rank
            W = _round_up(len(idxs), self.dp)
            sel = idxs + [idxs[0]] * (W - len(idxs))  # pad with a repeat row
            W_loc = W // self.dp
            mine = np.asarray(sel[d * W_loc:(d + 1) * W_loc])
            if self.strategy == "interval":
                M_loc = M // self.sp
                cand = self._gather(lo[mine], hi[mine], M_loc, s * M_loc)
            else:
                cand = self._gather(lo[mine], hi[mine], M)
            qs = [windows[i][1] for i in mine]
            out = fn(mesh, *cand, qs, k, L=L, n_docs=self.n_docs, strategy=self.strategy)
            out = mesh.all_gather(out, "sp").transpose(0, 1)  # [W_loc, sp, L/sp(, C)]
            out = out.reshape((W_loc, L) + out.shape[3:])
            out = mesh.all_gather(out, "dp").reshape((W, L) + out.shape[2:])
            outs.append(out[: len(idxs)])
            order += idxs
        host = engine_mod._to_host(torch.cat(outs))
        results: list[np.ndarray | None] = [None] * len(windows)
        for j, i in enumerate(order):
            results[i] = host[j, : lens[i]]
        return results

    def conservation(self, windows: list[tuple[str, int, int]], k: int) -> list[np.ndarray]:
        """Per-window int32 conservation arrays (reference memo_query.py:70)."""
        return self._run(windows, k, membership=False)

    def membership(self, windows: list[tuple[str, int, int]], k: int) -> list[np.ndarray]:
        """Per-window int8 [len, n] presence matrices (memo_query.py:67-68)."""
        return self._run(windows, k, membership=True)
