"""Host ms a traced request spent bringing its answers back, less the wait
on its own kernels: the program's ``memo.copy_back`` spans (the wait on the
work queued before the copy, and the copy), over the traced window, less
the time a kernel ran on the device inside them; over the traced requests.
Nothing where the program records no such span."""

from portbench import program


def read(run):
    if run.trace is None or not run.traced:
        return None
    spans = program.spans(run.trace, "memo.copy_back")
    if not len(spans):
        return None
    return (program.span_us(spans) - program.kernel_us_within(run.trace, spans)) / run.traced / 1e3
