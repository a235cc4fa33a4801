"""Host ms per traced request: its wall, issue to host arrays in hand, less
the time the device was busy inside it; the mean over the traced requests."""


def read(run):
    if run.trace is None or not run.traced or not run.trace.device:
        return None
    return float(run.trace.host_us().mean()) / 1e3
