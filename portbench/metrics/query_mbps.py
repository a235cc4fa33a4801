"""Window positions answered over the window's seconds, in Mbp/s: every
request of the window, from the first issue to the last return."""


def read(run):
    return sum(d.positions for d in run.done if not d.failed) / run.window_s / 1e6
