"""Tracking: Gauss-Newton iterations a frame, counted as calls of
``vo/dvo.py``'s ``_normal_equations`` over the window's frames.
Moves ``pose_ms_p95``."""

UNIT = "iters"


def read(record):
    return record.per_frame("normal_equations")
