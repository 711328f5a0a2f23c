"""Features: FAST and BRIEF on each VITAMIN-E frame, the port's
``extract`` span (``vo/vitamin_e.py``) over the program-traced frames,
in ms a frame.  Moves ``pose_ms_p95``."""

UNIT = "ms"


def read(record):
    if "ve.estimate" not in record.program_spans:
        return None
    return record.program_ms("extract")
