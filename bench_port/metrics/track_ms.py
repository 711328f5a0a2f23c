"""Tracking, ``vo/dvo.py``'s pyramid as the apps call it: the mean
time of the harness's "track" span (synchronized at both ends) over
the window's frames, in ms.  Moves ``pose_ms_p95``."""

UNIT = "ms"


def read(record):
    mean = record.span_mean("track")
    return None if mean is None else 1e3 * mean
