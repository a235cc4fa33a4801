"""The share of the traced window in which no device operation ran, in %:
100 x (1 - busy / window), the busy time the union of every kernel, copy and
memset."""


def read(run):
    return None if run.trace is None else run.trace.idle_pct()
