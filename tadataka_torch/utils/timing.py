"""Wall time of named stages, for measurement scripts.

Code marks a stage with ``with stage(name, device):``.  That costs one
check while no ``record()`` block is open; inside it, each stage is
timed between two synchronizations of its device and its milliseconds
are added to the block's dict under ``name``::

    with record() as ms:
        vo.estimate(frame)
    ms   # {"extract": ..., "match": ..., ...}
"""

import time
from contextlib import contextmanager

import torch

_ms = None   # the open record() block's dict


@contextmanager
def record():
    """A dict of {stage: ms} of the stages run inside the block."""
    global _ms
    _ms = {}
    try:
        yield _ms
    finally:
        _ms = None


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextmanager
def stage(name, device):
    ms = _ms
    if ms is None:
        yield
        return
    _sync(device)
    t0 = time.perf_counter()
    yield
    _sync(device)
    ms[name] = ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
