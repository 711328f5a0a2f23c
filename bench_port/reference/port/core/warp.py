"""Back-project, rigid transform, re-project (counterpart of
``tadataka_tpu/core/warp.py``)."""

from bench_port.reference.port.core.projection import pi, inv_pi
from bench_port.reference.port.core.transforms import (
    relative_transform, transform_points)


def warp_depth(T10, x0, depth0):
    """Warp normalized coords x0 (..., 2) at depth0 (...,) through T10.

    Returns (x1 (..., 2), depth1 (...,))."""
    P1 = transform_points(T10, inv_pi(x0, depth0))
    return pi(P1), P1[..., 2]


def warp2d(T10, camera_model0, camera_model1, us0, depths0):
    """Pixel-coordinate warp: unnormalize(warp(normalize(u0), d0))."""
    xs1, depths1 = warp_depth(T10, camera_model0.normalize(us0), depths0)
    return camera_model1.unnormalize(xs1), depths1


class Warp3D:
    """World-frame 3D point warp between two camera poses (camera ->
    world): P1 = T10 P0."""

    def __init__(self, pose_w0, pose_w1):
        self.T10 = relative_transform(pose_w1.T, pose_w0.T)

    def __call__(self, P0):
        return transform_points(self.T10, P0)


class Warp2D:
    """Camera-to-camera pixel warp given two camera -> world poses."""

    def __init__(self, camera_model0, camera_model1, pose_w0, pose_w1):
        self.camera_model0 = camera_model0
        self.camera_model1 = camera_model1
        self.T10 = relative_transform(pose_w1.T, pose_w0.T)

    def __call__(self, us0, depths0):
        return warp2d(self.T10, self.camera_model0, self.camera_model1,
                      us0, depths0)


class LocalWarp2D:
    """Pixel warp under a single relative pose10."""

    def __init__(self, camera_model0, camera_model1, pose10):
        self.camera_model0 = camera_model0
        self.camera_model1 = camera_model1
        self.T10 = pose10.T

    def __call__(self, us0, depths0):
        return warp2d(self.T10, self.camera_model0, self.camera_model1,
                      us0, depths0)
