"""Feature tracking: the curvature, the hill climb of every track and
the keypoints spawned in the new area, the port's ``curvature + climb``
and ``new area`` spans over the program-traced frames, in ms a frame.
Moves ``pose_ms_p95``."""

UNIT = "ms"


def read(record):
    parts = [record.program_ms(name)
             for name in ("curvature + climb", "new area")]
    if "ve.estimate" not in record.program_spans or None in parts:
        return None
    return sum(parts)
