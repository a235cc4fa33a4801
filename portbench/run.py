"""Runs one cell of the port's benchmark once; from the checkout's root:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``. The last line of
standard output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, the numbers compared with their limits. Exits non-zero, printing
no result, where the cell's CUDA devices are missing or a module of JAX or
of the JAX package was loaded. See ``portbench/harness.py``.
"""

import time

T_START = time.perf_counter()  # set-up counts from here

import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START, ROOT))
