"""Apps and host: the program's host synchronizations a frame, counted
by ``torch.cuda.set_sync_debug_mode("warn")`` over five window frames
of their own (the harness's own synchronizations left out; counting
slows the host, so these frames are neither profiled nor in the spans'
means).  Moves ``fps``."""

UNIT = "syncs"


def read(record):
    return (record.syncs / record.sync_frames if record.sync_frames
            else None)
