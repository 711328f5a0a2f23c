"""The device: the share of the profiled frames' wall span in which no
operation ran on the card, 100 (1 - busy / span).  The profiler slows
the host, so this is an upper bound.  Moves ``fps``."""

UNIT = "%"


def read(record):
    if not record.profiled or record.window_s <= 0:
        return None
    return 100.0 * (1.0 - record.busy_s / record.window_s)
