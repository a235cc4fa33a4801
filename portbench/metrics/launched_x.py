"""Positions the traced requests launched the fused kernels over (the
program's counter ``memo.positions_launched``: windows x length of each
launch) over the positions they answered: 1 where no launch pads."""

from portbench import program


def read(run):
    if run.trace is None or not run.traced:
        return None
    return program.per(program.counter("memo.positions_launched"), run.traced_work[1])
