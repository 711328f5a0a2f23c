"""Bilinear image interpolation at float [x, y] coordinates (counterpart
of ``tadataka_tpu/core/interpolation.py``)."""

import torch

from bench_port.reference.port.core.image_range import is_in_image_range


def interpolate(image, coordinates):
    """Sample image (H, W) at coordinates (..., 2) in [x, y] order.

    Four clipped taps; the fractional offsets are taken BEFORE the clip,
    so exact-integer coordinates are exact and every lane is finite.
    Range checking is the caller's concern.
    """
    H, W = image.shape
    cx, cy = coordinates[..., 0], coordinates[..., 1]
    lx, ly = torch.floor(cx), torch.floor(cy)
    ax, ay = cx - lx, cy - ly
    # clip in float before the integer cast (no out-of-range conversion)
    x0 = torch.clamp(lx, 0, W - 1).to(torch.int64)
    y0 = torch.clamp(ly, 0, H - 1).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    flat = image.reshape(-1)
    v00 = flat[y0 * W + x0]
    v01 = flat[y0 * W + x1]
    v10 = flat[y1 * W + x0]
    v11 = flat[y1 * W + x1]
    return ((1.0 - ax) * (1.0 - ay) * v00 + ax * (1.0 - ay) * v01
            + (1.0 - ax) * ay * v10 + ax * ay * v11)


def interpolate_checked(image, coordinates, fill=0.0):
    """Bilinear samples and the in-range mask (float-inclusive [0, W-1] x
    [0, H-1]); out-of-range lanes get ``fill``.  Returns (values, mask)."""
    mask = is_in_image_range(coordinates, image.shape)
    values = interpolate(image, coordinates)
    return torch.where(mask, values, fill), mask
