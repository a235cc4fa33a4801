"""Host ms a traced request spent queueing its device work: the union of
the program's ``memo.window_step`` (the window search's host work and
launch) and ``memo.launch`` (the fused kernels' wrapper: groups, checks,
launches) spans over the traced window, over the traced requests. Nothing
where the program records no such span."""

from portbench import program


def read(run):
    if run.trace is None or not run.traced:
        return None
    spans = program.spans(run.trace, "memo.window_step", "memo.launch")
    return program.span_us(spans) / run.traced / 1e3 if len(spans) else None
