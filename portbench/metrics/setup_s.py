"""Seconds from the start of run.py to the first timed request: device
start-up, the kernels loaded (built on a checkout's first run), the inputs
made, ``QueryEngine(...)`` and the warm-up of the cell's own shapes."""


def read(run):
    return run.setup_s
