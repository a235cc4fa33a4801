"""Rows the traced requests handed the fused kernels (the program's
counter ``memo.candidate_rows``: both candidate ranges of every launched
window) over the rows that mark their windows (``work.py``, the roofline's
count): how many rows the kernels read for each one they need."""

from portbench import program


def read(run):
    if run.trace is None or not run.traced:
        return None
    return program.per(program.counter("memo.candidate_rows"), run.traced_work[0])
