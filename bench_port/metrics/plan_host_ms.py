"""Apps and host, the planner: the time of the port's ``sd.plan`` span
(``SemiDenseVO._plan``: the plan cache's look-up and, on a miss,
``plan_update_np``) over the program-traced frames, in ms a frame.
Moves ``fps``."""

UNIT = "ms"


def read(record):
    return record.program_ms("sd.plan")
