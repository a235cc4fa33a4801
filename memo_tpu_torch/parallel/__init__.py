"""The batch strategies of :mod:`memo_tpu.parallel` on one device."""

from memo_tpu_torch.parallel.resident import ResidentShardedQuery  # noqa: F401
from memo_tpu_torch.parallel.sharded import ShardedQuery, check_layout  # noqa: F401
