"""memo_tpu_torch — the memo-tpu query engine on PyTorch and CUDA.

:mod:`memo_tpu` (the JAX package, which stays the reference) rewritten for an
NVIDIA GPU: conservation and membership queries, single windows and batches,
with the fused query as hand-written CUDA kernels for Hopper (``csrc/``). The
host side (index building and the native MS library, the interval store and
its query layout, output formatting, plotting) is the port's own copy of
memo_tpu's: this package imports neither :mod:`memo_tpu` nor JAX, and its
index files are interchangeable with memo_tpu's.
"""

__version__ = "0.1.0"

from memo_tpu_torch.index.store import IntervalStore  # noqa: F401
from memo_tpu_torch.query.engine import QueryEngine  # noqa: F401
