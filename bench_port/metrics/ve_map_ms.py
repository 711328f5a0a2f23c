"""Mapping: the (re)triangulation of each VITAMIN-E frame's tracks, the
port's ``triangulate`` span, plus the self time of its root span
``ve.estimate`` (the host's id bookkeeping between the stages), over
the program-traced frames, in ms a frame.  Moves ``fps``."""

UNIT = "ms"


def read(record):
    root = record.program_ms("ve.estimate", self_time=True)
    if root is None:
        return None
    return root + (record.program_ms("triangulate") or 0.0)
