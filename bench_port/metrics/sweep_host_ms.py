"""The depth update's sweep: the self time of the port's ``sd.sweep``
span (``apps/semi_dense_vo.update``: the planned update's launches and
its host work, without the syncs under it) over the program-traced
frames, in ms a frame.  Moves ``fps``."""

UNIT = "ms"


def read(record):
    return record.program_ms("sd.sweep", self_time=True)
