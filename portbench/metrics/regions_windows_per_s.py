"""Windows answered over the window's seconds: every batch of the window,
from the first issue to the last return."""


def read(run):
    return sum(len(d.windows) for d in run.done if not d.failed) / run.window_s
