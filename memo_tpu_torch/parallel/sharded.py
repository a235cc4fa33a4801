"""Batched window queries with host-gathered candidates over a (dp, sp) mesh.

Counterpart of :mod:`memo_tpu.parallel.sharded`. memo_tpu runs a batch of
windows SPMD over a ``jax.sharding.Mesh`` from one controller; the port uses
torch's multi-controller idiom instead: one process per device, all in one
``torch.distributed`` process group (NCCL on GPUs, gloo on the CPU), each
running this same code on the same host store and calling the same
collectives in the same order. The mesh axes shard what memo_tpu's do:

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

from memo_tpu_torch.ops import query_ops as Q
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

    Gathers per-window candidate rows host-side (store.window_bounds), pads
    them to a shared pow2 bucket, and computes each bucket's windows on the
    mesh. ``mesh`` is a :class:`Mesh`, None (:func:`make_mesh`'s default) or
    a device for the 1 x 1 layout on it. Every rank returns every window's
    output; results are bit-identical to the single-window engine.
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

    def _window_rows(self, windows: list[tuple[str, int, int]], k: int):
        """Candidate row range (lo, hi) per (record, qs, qe) window."""
        st = self.store
        rows = []
        for record, qs, qe in windows:
            lo, hi = st.window_bounds(record, qs, qe, k)
            rec_end = int(st.rec_offsets[st.record_index(record) + 1])
            rows.append((lo, min(hi, rec_end)))  # rows past the record are another record's space
        return rows

    def _gather(self, rows: list[tuple[int, int]], M: int, col0: int = 0):
        """Columns [col0, col0 + M) of the padded candidate rows of ``rows``,
        as [W, M] tensors on the device."""
        st = self.store
        W = len(rows)
        starts = np.zeros((W, M), np.int32)
        ends = np.zeros((W, M), np.int32)
        orders = np.full((W, M), -1, np.int32)  # order<0 rows are dropped
        for i, (lo, hi) in enumerate(rows):
            lo, hi = lo + col0, min(hi, lo + col0 + M)
            m = max(hi - lo, 0)
            starts[i, :m] = st.start[lo:hi]
            ends[i, :m] = st.end[lo:hi]
            orders[i, :m] = st.order[lo:hi]
        return tuple(torch.from_numpy(a).to(self.device) for a in (starts, ends, orders))

    def _run(self, windows, k: int, membership: bool):
        if not windows:
            return []
        mesh = self.mesh
        d, s = mesh.coord("dp"), mesh.coord("sp")
        lens = [qe - qs for _, qs, qe in windows]
        L = _round_up(max(max(lens), 1), self.sp)
        rows = self._window_rows(windows, k)
        # Bucket windows by next-pow2 candidate count, so that one dense
        # window does not inflate every window's padding to the batch max.
        buckets: dict[int, list[int]] = {}
        for i, (lo, hi) in enumerate(rows):
            M = _round_up(max(_next_pow2(hi - lo), self.sp), self.sp)
            buckets.setdefault(M, []).append(i)
        fn = membership_batch if membership else conservation_batch
        results: list[np.ndarray | None] = [None] * len(windows)
        for M, idxs in sorted(buckets.items()):  # the same order on every rank
            W = _round_up(len(idxs), self.dp)
            sel = idxs + [idxs[0]] * (W - len(idxs))  # pad with a repeat row
            W_loc = W // self.dp
            mine = sel[d * W_loc:(d + 1) * W_loc]
            if self.strategy == "interval":
                M_loc = M // self.sp
                cand = self._gather([rows[i] for i in mine], M_loc, s * M_loc)
            else:
                cand = self._gather([rows[i] for i in mine], M)
            qs = [windows[i][1] for i in mine]
            out = fn(mesh, *cand, qs, k, L=L, n_docs=self.n_docs, strategy=self.strategy)
            out = mesh.all_gather(out, "sp").transpose(0, 1)  # [W_loc, sp, L/sp(, C)]
            out = out.reshape((W_loc, L) + out.shape[3:])
            out = mesh.all_gather(out, "dp").reshape((W, L) + out.shape[2:])
            out = out.cpu().numpy()
            for j, i in enumerate(idxs):
                results[i] = out[j, : lens[i]]
        return results

    def conservation(self, windows: list[tuple[str, int, int]], k: int) -> list[np.ndarray]:
        """Per-window int32 conservation arrays (reference memo_query.py:70)."""
        return self._run(windows, k, membership=False)

    def membership(self, windows: list[tuple[str, int, int]], k: int) -> list[np.ndarray]:
        """Per-window int8 [len, n] presence matrices (memo_query.py:67-68)."""
        return self._run(windows, k, membership=True)
