"""Multi-process initialization and the global mesh.

Counterpart of :mod:`memo_tpu.parallel.distributed`, in torch's
multi-controller idiom: one process per device, all running the same
program on the same host store, joined in one ``torch.distributed`` process
group. ``torchrun --nproc-per-node N`` starts the processes and sets
``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/
``LOCAL_WORLD_SIZE``, which :func:`initialize` reads where it is given no
arguments (memo_tpu reads ``JAX_*``).

The backend follows the device: NCCL for ``cuda`` (each process on the GPU
``LOCAL_RANK``), gloo for ``cpu``. Nothing swaps one for the other: a CUDA
group on a machine without CUDA raises.

``make_global_mesh`` lays ``dp`` across hosts and ``sp`` within a host, as
memo_tpu does, so the only collective that sums (the ``interval``
strategy's reduce-scatter) stays within a host.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from memo_tpu_torch.parallel.sharded import make_mesh
from memo_tpu_torch.utils.device import resolve_device
from memo_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

TIMEOUT_S = 60.0  # a rank that fails before a collective stops the others after this


def launched() -> bool:
    """Whether this process was started by torchrun (or another launcher that
    sets the process group's environment)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device: str = "cuda",
) -> bool:
    """Join this process to the process group (idempotent); returns whether
    this call created it.

    ``coordinator_address`` is ``host:port`` (TCP) or an ``init_method`` URL
    such as ``file:///path`` (no port needed); with none, the launcher's
    environment (``env://``). ``num_processes``/``process_id`` default to
    ``WORLD_SIZE``/``RANK``. For ``device="cuda"`` the process first takes the
    GPU ``LOCAL_RANK`` (default: its rank) and joins with NCCL; for "cpu",
    gloo.
    """
    if dist.is_initialized():
        return False
    dev = resolve_device(device)
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if num_processes is None or process_id is None:
        if not launched():
            raise ValueError("no RANK/WORLD_SIZE in the environment: launch under torchrun or "
                             "pass num_processes and process_id")
    world = int(num_processes if num_processes is not None else os.environ["WORLD_SIZE"])
    rank = int(process_id if process_id is not None else os.environ["RANK"])
    kwargs = {}
    if dev.type == "cuda":
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local_rank)
        kwargs["device_id"] = torch.device("cuda", local_rank)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=init_method,
        world_size=world,
        rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
        **kwargs,
    )
    log.info("process group initialized: rank %d/%d, backend %s", rank, world, dist.get_backend())
    return True


def shutdown() -> None:
    """Wait for every rank, then leave the process group."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def make_global_mesh(device_type: str = "cuda"):
    """(dp, sp) mesh with dp across hosts and sp within a host
    (``LOCAL_WORLD_SIZE`` ranks; default: all of them, one host)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return make_mesh(dp=world // local, sp=local, device_type=device_type)
