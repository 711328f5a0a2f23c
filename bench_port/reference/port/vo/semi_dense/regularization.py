"""3x3 inverse-variance-weighted depth smoothing over SUCCESS pixels
(counterpart of ``tadataka_tpu/vo/semi_dense/regularization.py``)."""

import torch
import torch.nn.functional as F

from bench_port.reference.port.flags import Flag
from bench_port.reference.port.vo.semi_dense.estimator import safe_invert


def _box3_rows(x):
    """3x3 box sums of x (..., H, w + 2) whose first and last columns
    are a halo: the columns' taps from x, the rows zero-padded; (..., H,
    w), as shifted adds (no convolution)."""
    h = x[..., :-2] + x[..., 1:-1] + x[..., 2:]
    p = F.pad(h, (0, 0, 1, 1))
    return p[..., :-2, :] + p[..., 1:-1, :] + p[..., 2:, :]


def _box3(x):
    """SAME zero-padded 3x3 box sum."""
    return _box3_rows(F.pad(x, (1, 1)))


def regularize(depth_map, variance_map, flag_map):
    """Weighted 3x3 smoothing of inverse depth; non-SUCCESS pixels keep
    their value and contribute nothing."""
    success = (flag_map == int(Flag.SUCCESS)).to(depth_map.dtype)
    inv_depth = safe_invert(depth_map)
    inv_var = safe_invert(variance_map) * success
    numerator = _box3(inv_depth * inv_var)
    denominator = _box3(inv_var)
    smoothed = safe_invert(numerator / torch.clamp(denominator, min=1e-12))
    return torch.where(denominator > 0, smoothed, depth_map)
