"""Apps and host: the time a VITAMIN-E frame waits in its blocking
reads, the summed durations of the port's ``sync.ve.*`` spans, of its
host factorizations' ``sync.solvers.on_host`` spans and of the reads
inside the features and the camera on its path (``sync.curvature.*``:
the percentile's index; ``sync.distortion.*``: RadTan's convergence
test) over the program-traced frames, in ms a frame.  Moves ``fps``."""

UNIT = "ms"


def read(record):
    if "ve.estimate" not in record.program_spans:
        return None
    sites = [name for name in record.program_spans
             if name.startswith(("sync.ve.", "sync.curvature.",
                                 "sync.distortion."))
             or name == "sync.solvers.on_host"]
    return sum(record.program_ms(name) for name in sites)
