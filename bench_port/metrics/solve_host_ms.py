"""Tracking, the host half of each Gauss-Newton iteration: the self
time of the port's ``dvo.solve`` span (``vo/dvo.py``: the 6x6 solve and
the step composed on the host) over the program-traced frames, in ms a
frame.  Moves ``pose_ms_p95``."""

UNIT = "ms"


def read(record):
    return record.program_ms("dvo.solve", self_time=True)
