"""memo_tpu_torch — the memo-tpu query engine on PyTorch and CUDA.

The device side of :mod:`memo_tpu` (the JAX package, which stays the
reference) rewritten for an NVIDIA GPU: the single-window conservation and
membership query, with the fused query as a hand-written CUDA kernel for
Hopper (``csrc/fused_query.cu``). The host side (index building, the interval
store and its query layout, output formatting, plotting) is :mod:`memo_tpu`'s
own, imported and not copied; none of it imports JAX, and neither does this
package.
"""

__version__ = "0.1.0"

from memo_tpu.index.store import IntervalStore  # noqa: F401
from memo_tpu_torch.query.engine import QueryEngine  # noqa: F401
