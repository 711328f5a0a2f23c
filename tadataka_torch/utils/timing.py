"""Wall time of named stages, and the values they produce, for
measurement scripts.

Code marks a stage with ``with stage(name, device):``.  That costs one
check while no ``record()`` block is open; inside it, each stage is
timed between two synchronizations of its device and its milliseconds
are added to the block's dict under ``name``::

    with record() as ms:
        vo.estimate(frame)
    ms   # {"extract": ..., "match": ..., ...}

Code marks a stage's outputs with ``probe(stage, name=value, ...)``.
That costs one check while no ``capture()`` block is open; inside it,
each value is copied to the host and appended to the block's list as
``(stage, name, numpy array)``, in the order the code produced them, so
that two runs (on the CPU and on the card) can be compared entry by
entry::

    with capture() as values:
        vo.estimate(frame)
"""

import time
from contextlib import contextmanager

import numpy as np
import torch

_ms = None       # the open record() block's dict
_values = None   # the open capture() block's list


@contextmanager
def record():
    """A dict of {stage: ms} of the stages run inside the block."""
    global _ms
    _ms = {}
    try:
        yield _ms
    finally:
        _ms = None


@contextmanager
def capture():
    """A list of (stage, name, value) of the values probed inside the
    block."""
    global _values
    _values = []
    try:
        yield _values
    finally:
        _values = None


def probe(stage, **values):
    """Inside a ``capture()`` block, append each value's host copy."""
    if _values is None:
        return
    for name, value in values.items():
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        _values.append((stage, name, np.asarray(value)))


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
