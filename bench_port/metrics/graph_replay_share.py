"""Tracking: the share of the Gauss-Newton iterations that replayed a
level's CUDA graph, the port's counter ``dvo.graph_replay`` over its
``dvo.gn_iter`` on the program-traced frames, in % (0 where every
iteration ran eagerly).  Moves ``pose_ms_p95``."""

UNIT = "%"


def read(record):
    iterations = record.program_counts.get("dvo.gn_iter")
    if not iterations:
        return None
    return 100.0 * record.program_counts.get("dvo.graph_replay", 0) / \
        iterations
