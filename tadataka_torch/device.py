"""The device an entry point runs on."""

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
