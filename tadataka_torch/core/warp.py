"""Back-project, rigid transform, re-project (counterpart of
``tadataka_tpu/core/warp.py``)."""

from tadataka_torch.core.projection import pi, inv_pi
from tadataka_torch.core.transforms import transform_points


def warp_depth(T10, x0, depth0):
    """Warp normalized coords x0 (..., 2) at depth0 (...,) through T10.

    Returns (x1 (..., 2), depth1 (...,))."""
    P1 = transform_points(T10, inv_pi(x0, depth0))
    return pi(P1), P1[..., 2]


def warp2d(T10, camera_model0, camera_model1, us0, depths0):
    """Pixel-coordinate warp: unnormalize(warp(normalize(u0), d0))."""
    xs1, depths1 = warp_depth(T10, camera_model0.normalize(us0), depths0)
    return camera_model1.unnormalize(xs1), depths1
