"""The depth update, ``apps/semi_dense_vo.update`` (the planned sweep
and the regularization): the mean time of the harness's "update" span
over the window's frames, in ms.  Moves ``fps``."""

UNIT = "ms"


def read(record):
    mean = record.span_mean("update")
    return None if mean is None else 1e3 * mean
