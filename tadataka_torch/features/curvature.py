"""Image curvature and its extrema, VITAMIN-E's keypoints (counterpart of
``tadataka_tpu/features/curvature.py``): kappa = fy^2 fxx - fx fy fxy -
fy fx fyx + fx^2 fyy from reflect-border Sobel derivatives; the
extrema are the pixels above a percentile of the curvature, the
strongest K first with a validity mask.

Parity, and the same bits on the CPU and the card:
- Each product and difference of the curvature is its own rounded op.
  XLA's CPU compiler may fuse a * b + c into one FMA, so against the JAX
  package the curvature agrees to a relative rounding, not to the bit.
- ``jnp.percentile(c, p)`` is ``quantile(p / 100, method="linear")``: the
  sorted values s, q = (p / 100) (n - 1) in float32, and s[floor q] (1 -
  w) + s[ceil q] w with w = q - floor q.  ``torch.quantile`` uses
  ``lerp`` (another formula, which the card may contract into an FMA),
  so :func:`percentile_of` writes JAX's out as separate ops.
- ``lax.top_k`` over the map set to -inf below the threshold is a
  stable descending sort (equal values keep their index order), as
  ``features/detector.py`` does it; the mask is ``isfinite(vals)``.
"""

import torch

from tadataka_torch.core.gradients import grad_x, grad_y
from tadataka_torch.core.rounding import as_divisor
from tadataka_torch.utils.timing import sync_point


def compute_curvature(fx, fy, fxx, fxy, fyx, fyy):
    f2x = fx * fx
    f2y = fy * fy
    return f2y * fxx - fx * fy * fxy - fy * fx * fyx + f2x * fyy


def compute_image_curvature(image):
    gx = grad_x(image)
    gy = grad_y(image)
    return compute_curvature(gx, gy, grad_x(gx), grad_y(gx), grad_x(gy),
                             grad_y(gy))


def percentile_of(x, p):
    """``jnp.percentile(x, p)`` of all of x (float32, NaN-free)."""
    s = torch.sort(x.reshape(-1)).values
    q = torch.full((), p, dtype=s.dtype, device=s.device)
    q = q / as_divisor(100.0, q) * as_divisor(s.numel() - 1, q)
    low = torch.floor(q)
    high_weight = q - low
    low_weight = 1.0 - high_weight
    lo = low.long().clamp(0, s.numel() - 1)
    hi = torch.ceil(q).long().clamp(0, s.numel() - 1)
    # a 0-d index tensor is read to the host, once for each side
    with sync_point("sync.curvature.percentile", 2):
        return s[lo] * low_weight + s[hi] * high_weight


def extract_curvature_extrema(image, percentile=95.0, max_keypoints=1024):
    """Keypoints ([x, y], (K, 2) float32) where the curvature exceeds the
    given percentile, strongest first, and their validity mask (K,)."""
    return curvature_extrema(compute_image_curvature(image), percentile,
                             max_keypoints)


def curvature_extrema(curvature, percentile=95.0, max_keypoints=1024):
    """``extract_curvature_extrema`` of an image's curvature map."""
    threshold = percentile_of(curvature, percentile)
    H, W = curvature.shape
    flat = torch.where(curvature > threshold, curvature,
                       float("-inf")).reshape(-1)
    vals, idx = torch.sort(flat, descending=True, stable=True)
    vals, idx = vals[:max_keypoints], idx[:max_keypoints]
    keypoints = torch.stack([(idx % W).to(torch.float32),
                             (idx // W).to(torch.float32)], dim=-1)
    return keypoints, torch.isfinite(vals)
