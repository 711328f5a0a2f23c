"""Features: the affine flow of each VITAMIN-E frame (matching, the
fundamental-matrix RANSAC and homography filter, the IRLS fit), the
port's ``flow`` span over the program-traced frames, in ms a frame.
Moves ``pose_ms_p95``."""

UNIT = "ms"


def read(record):
    if "ve.estimate" not in record.program_spans:
        return None
    return record.program_ms("flow")
