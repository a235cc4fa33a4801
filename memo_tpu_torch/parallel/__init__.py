"""Multi-device execution: the batch strategies of :mod:`memo_tpu.parallel` over
a (dp, sp) mesh of ranks in one torch.distributed process group."""

from memo_tpu_torch.parallel.sharded import (  # noqa: F401
    Mesh,
    ShardedQuery,
    check_layout,
    conservation_batch,
    make_mesh,
    membership_batch,
)
from memo_tpu_torch.parallel.resident import ResidentShardedQuery  # noqa: F401
from memo_tpu_torch.parallel.distributed import initialize, make_global_mesh  # noqa: F401
