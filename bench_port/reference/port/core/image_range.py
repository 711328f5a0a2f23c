"""Float-inclusive image bounds tests (counterpart of
``tadataka_tpu/core/image_range.py``): 0 <= x <= W-1 and 0 <= y <= H-1."""

import torch


def is_in_image_range(coordinates, image_shape):
    """coordinates (..., 2) in [x, y]; image_shape = (H, W[, ...])."""
    H, W = image_shape[0], image_shape[1]
    x = coordinates[..., 0]
    y = coordinates[..., 1]
    return (0.0 <= x) & (x <= W - 1.0) & (0.0 <= y) & (y <= H - 1.0)


def all_in_image_range(coordinates, image_shape):
    """Whether every coordinate along the second-to-last axis is in range:
    (..., n, 2) -> (...,)."""
    return torch.all(is_in_image_range(coordinates, image_shape), dim=-1)
