"""Bundle-adjustment reprojection residuals and Jacobians (counterpart of
``tadataka_tpu/ba/residuals.py``): project(exp(omega) p + t), with the
2x6 pose and 2x3 point Jacobians from ``torch.func.jacfwd`` under
``torch.func.vmap`` over the observations.  The rotation's products sum
left to right and ``exp_so3`` is device-invariant, so the CPU and the
card give the same bits."""

import torch

from tadataka_torch.core.projection import pi
from tadataka_torch.core.rounding import matmul_small
from tadataka_torch.core.so3 import exp_so3


def transform_project(pose_params, point):
    """pose_params = [omega (3), t (3)]; point (3,) -> projected (2,)."""
    omega, t = pose_params[..., :3], pose_params[..., 3:]
    return pi(matmul_small(exp_so3(omega), point[..., None])[..., 0] + t)


pose_jacobian = torch.func.jacfwd(transform_project, argnums=0)
point_jacobian = torch.func.jacfwd(transform_project, argnums=1)
_pose_jacobians = torch.func.vmap(pose_jacobian)
_point_jacobians = torch.func.vmap(point_jacobian)


def projection_residuals(poses, points, viewpoint_indices, point_indices,
                         x_true):
    """r_o = x_true_o - project(pose_j(o), point_i(o)) for poses (M, 6),
    points (N, 3) and index arrays (O,).  Returns (O, 2)."""
    return x_true - transform_project(poses[viewpoint_indices],
                                      points[point_indices])


def projection_jacobians(poses, points, viewpoint_indices, point_indices):
    """(A, B): the per-observation 2x6 pose and 2x3 point Jacobians."""
    pose_o = poses[viewpoint_indices]
    point_o = points[point_indices]
    return _pose_jacobians(pose_o, point_o), _point_jacobians(pose_o, point_o)
