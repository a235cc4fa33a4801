"""The kernels' share of their roofline over the traced requests, in %: the
least time the card could take for them (``work.py``: every marking row
read once as 12 bytes and every answered position written once as 4, over
the peak memory rate of ``peaks.json``) over the device time of the
kernels they ran (the window step, the fused kernels and any other kernel;
copies left out). Nothing where no kernel ran or the card has no peak."""

from portbench import work


def read(run):
    if run.trace is None or not run.traced:
        return None
    kernels_s = run.trace.kernel_us() * 1e-6
    least = work.least_seconds(*run.traced_work, run.kind)
    return None if least is None or kernels_s <= 0 else 100.0 * least / kernels_s
