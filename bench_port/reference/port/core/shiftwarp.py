"""The warps of the rectified sweep (counterpart of
``tadataka_tpu/core/shiftwarp.py``).

The JAX package runs these as tent-weighted shift sums under a static
displacement budget, because XLA:TPU gathers were slow.  The port keeps
only their plain forms: ``rot_warp`` is the two-pass gather warp of
``warp2pass.py`` with the JAX function's validity but no budget, and
``const_shift_cols`` is one fractional column shift by a device scalar,
built from index arithmetic on the device (no host sync).
"""

import torch

from bench_port.reference.port.core.warp2pass import EPSILON, _warp  # noqa: F401


def rot_warp(img, H33, fill=-1.0, eps=1e-6, out_rows=None):
    """Homography warp of ``img`` (H, W) or (C, H, W) by one ``H33``
    (3, 3): out(x', y') = img(U, V) with (U, V, 1) ~ H33 @ (x', y', 1).
    ``out_rows = (y0, n)`` computes only the output rows y0 .. y0+n-1
    (the row-sharded path's block), each lane as in the whole warp.

    Returns (warped, valid (n, W)).  Valid lanes are in front of the
    projection plane, inside the image and off the rows where the
    two-pass decomposition is singular (|h11 - y' h21| < eps); invalid
    lanes hold ``fill``.
    """
    y0, n = (0, img.shape[-2]) if out_rows is None else out_rows
    yo = torch.arange(y0, y0 + n, dtype=img.dtype,
                      device=img.device)[:, None]
    xo = torch.arange(img.shape[-1], dtype=img.dtype,
                      device=img.device)[None, :]
    out, valid = _warp(img, H33, xo, yo, fill, eps)
    valid = valid & (torch.abs(H33[1, 1] - yo * H33[2, 1]) >= eps)
    return torch.where(valid, out, fill), valid


def const_shift_cols(img, shift, fill=-1.0):
    """Bilinear resample at one column shift, a 0-d tensor on the
    device: out[..., y, x] = img[..., y, x + shift].  A position outside
    the image, or touching it with only one of its two taps, holds
    ``fill``.  |shift| must be below the image width."""
    W = img.shape[-1]
    sf = torch.floor(shift)
    frac = shift - sf
    # first tap's column; the JAX form clamps its slice start to the
    # padded buffer, which is this clamp
    c0 = (torch.clamp(sf.to(torch.int64), -W, W)
          + torch.arange(W, device=img.device))
    c1 = c0 + 1
    in0 = (c0 >= 0) & (c0 < W)
    in1 = (c1 >= 0) & (c1 < W)
    v0 = torch.where(in0, img[..., torch.clamp(c0, 0, W - 1)], fill)
    v1 = torch.where(in1, img[..., torch.clamp(c1, 0, W - 1)], fill)
    out = (1.0 - frac) * v0 + frac * v1
    valid = (1.0 - frac) * in0.to(img.dtype) + frac * in1.to(img.dtype) \
        > 0.999
    return torch.where(valid, out, fill)
