"""Pose estimation: the bootstrap or PnP of each VITAMIN-E frame (EPnP
RANSAC and its Gauss-Newton refinement), the port's ``pose`` span over
the program-traced frames, in ms a frame.  Moves ``pose_ms_p95``."""

UNIT = "ms"


def read(record):
    if "ve.estimate" not in record.program_spans:
        return None
    return record.program_ms("pose")
