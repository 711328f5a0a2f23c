"""Pixel-grid coordinates (counterpart of ``tadataka_tpu/core/coordinates.py``)."""

import torch


def image_coordinates(image_shape, dtype=torch.float32, device="cpu"):
    """All pixel coordinates of an (H, W) image as (H*W, 2) in [x, y]
    order, row-major over y then x."""
    H, W = image_shape[0], image_shape[1]
    Y, X = torch.meshgrid(torch.arange(H, dtype=dtype, device=device),
                          torch.arange(W, dtype=dtype, device=device),
                          indexing="ij")
    return torch.stack([X.ravel(), Y.ravel()], dim=-1)
