"""Device ms of the window-parameters kernel (``csrc/window_params.cu``)
per traced request."""


def read(run):
    if run.trace is None or not run.traced:
        return None
    us = run.trace.device_us("window_params")
    return us / run.traced / 1e3 if us > 0 else None
