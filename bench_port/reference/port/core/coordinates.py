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


def image_coordinate_grid(image_shape, dtype=torch.float32, device="cpu"):
    """(H, W, 2) grid of [x, y] coordinates."""
    H, W = image_shape[0], image_shape[1]
    return image_coordinates(image_shape, dtype, device).reshape(H, W, 2)


def xy_to_yx(coords):
    return coords.flip(-1)


yx_to_xy = xy_to_yx


def get(image, us):
    """Image values at integer [x, y] coordinates (truncated toward 0)."""
    us = us.to(torch.int64)
    return image[us[..., 1], us[..., 0]]


def substitute(image, us, values):
    """A copy of the image with ``values`` at integer [x, y] coordinates."""
    us = us.to(torch.int64)
    out = image.clone()
    out[us[..., 1], us[..., 0]] = torch.as_tensor(values, dtype=out.dtype,
                                                  device=out.device)
    return out
