"""The device an entry point runs on, and host data sent to it without
a synchronization."""

import numpy as np
import torch


def resolve_device(device):
    """``device`` as a torch.device; raises if it names CUDA and there is
    no CUDA device (an entry point does not fall back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    return device


def upload(array, device, dtype=None):
    """A host array (or CPU tensor) on ``device``.  To a card it goes
    through pinned memory without blocking: a plain host-to-card copy
    synchronizes the stream."""
    t = array if isinstance(array, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(array))
    if dtype is not None:
        t = t.to(dtype)
    device = torch.device(device)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device, copy=True)


_constants = {}   # (id, device, dtype) -> (host array, device tensor)


def constant(array, device, dtype=None):
    """A host constant (a numpy array that its maker keeps, such as an
    ``lru_cache``'s) on ``device``, sent there once a device."""
    key = (id(array), torch.device(device), dtype)
    hit = _constants.get(key)
    if hit is None or hit[0] is not array:
        hit = _constants[key] = (array, upload(array, device, dtype))
    return hit[1]
