from memo_tpu_torch.index.intervals import mem_overlap_intervals  # noqa: F401
from memo_tpu_torch.index.store import IntervalStore  # noqa: F401
