"""Apps and host: the time the host waits in the port's blocking
transfers, the summed durations of its ``sync.<site>`` spans (a
``sync_point`` wraps one transfer and holds no other) over the
program-traced frames, in ms a frame.  Moves ``fps``."""

UNIT = "ms"


def read(record):
    sites = [name for name in record.program_spans
             if name.startswith("sync.")]
    if not sites:
        return None
    return sum(record.program_ms(name) for name in sites)
