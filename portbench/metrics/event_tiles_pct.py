"""The share of the traced requests' v1 conservation tiles that took the
event path, in %: the program's counter ``memo.event_tiles`` over
``memo.apply_tiles`` (every tile of a v1 conservation launch). Nothing where
the program has no such counters or launched no tile."""

from portbench import program


def read(run):
    if run.trace is None or not run.traced:
        return None
    tiles = program.counter("memo.apply_tiles")
    events = program.counter("memo.event_tiles")
    if not tiles or events is None:
        return None
    return 100.0 * events / tiles
