"""Bytes the traced requests brought to the host (the program's counter
``memo.copy_back_bytes``) over the bytes of their answers (4 a position):
1 where only the answered positions come back."""

from portbench import program, work


def read(run):
    if run.trace is None or not run.traced:
        return None
    return program.per(program.counter("memo.copy_back_bytes"), work.OUT_BYTES * run.traced_work[1])
