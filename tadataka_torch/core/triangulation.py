"""Triangulation: closed-form two-view depth and batched DLT (counterpart
of ``tadataka_tpu/core/triangulation.py``).  The (n_points, 2 n_views, 4)
DLT stack goes through one batched SVD, on the host
(``core/solvers.py``); the depths sum their products left to right, so
the CPU and the card give the same bits."""

import torch

from tadataka_torch.core.rounding import dot
from tadataka_torch.core.solvers import on_host, solve
from tadataka_torch.core.transforms import (
    to_homogeneous, get_rotation, get_translation)

EPSILON = 1e-16


def calc_depth0(T10, x0, x1):
    """Closed-form depth of x0 given the relative transform T10 and the
    match x1 (normalized coords (..., 2)); the axis is the one of the
    larger |t10| component."""
    R = get_rotation(T10)
    t = get_translation(T10)
    y0 = to_homogeneous(x0)

    def depth_along(i):
        n = t[i] - t[2] * x1[..., i]
        d = (y0 @ R[2]) * x1[..., i] - (y0 @ R[i])
        return n / (d + EPSILON)

    use_x = torch.abs(t[0]) > torch.abs(t[1])
    return torch.where(use_x, depth_along(0), depth_along(1))


def calc_depth0_poses(pose_w0, pose_w1, x0, x1):
    """calc_depth0 from world poses."""
    return calc_depth0((pose_w1.inv() * pose_w0).T, x0, x1)


def _dlt_solution(A):
    """Points (..., N, 3) from the DLT stacks A (..., N, rows, 4): the
    smallest right singular vector, dehomogenized; inf where w ~ 0."""
    X = on_host(lambda a: torch.linalg.svd(
        a, full_matrices=a.shape[-2] < 4)[2][..., -1, :], A)
    w = X[..., 3]
    degenerate = torch.abs(w) < 1e-12
    safe_w = torch.where(degenerate, torch.ones_like(w), w)
    points = X[..., :3] / safe_w[..., None]
    return (torch.where(degenerate[..., None], float("inf"), points),
            degenerate)


def _dlt_rows(R, t, kp):
    """Rows [x R[2] - R[0] | x t[2] - t[0]] and [y R[2] - R[1] | ...] of
    the DLT for R (..., 3, 3), t (..., 3) and kp (..., 2) -> (..., 2, 4)."""
    rows_xy = kp[..., None] * R[..., None, 2, :] - R[..., :2, :]
    cols = kp * t[..., None, 2] - t[..., :2]
    return torch.cat([rows_xy, cols[..., None]], dim=-1)


def linear_triangulation(rotations, translations, keypoints):
    """Batched N-view DLT triangulation.

    rotations (..., n_views, 3, 3) and translations (..., n_views, 3)
    world -> camera; keypoints (..., n_views, n_points, 2) normalized.
    Returns points (..., n_points, 3) (inf where degenerate) and depths
    (..., n_views, n_points) (NaN where degenerate)."""
    V, N = keypoints.shape[-3:-1]
    A = _dlt_rows(rotations[..., None, :, :], translations[..., None, :],
                  keypoints)
    A = A.transpose(-4, -3).reshape(A.shape[:-4] + (N, 2 * V, 4))
    points, degenerate = _dlt_solution(A)
    depths = (dot(rotations[..., :, None, 2, :], points[..., None, :, :])
              + translations[..., 2, None])
    return points, torch.where(degenerate[..., None, :], float("nan"),
                               depths)


def two_view_triangulation(pose0w, pose1w, keypoints0, keypoints1):
    """Triangulate matches across two views (poses world -> camera)."""
    return linear_triangulation(torch.stack([pose0w.R, pose1w.R]),
                                torch.stack([pose0w.t, pose1w.t]),
                                torch.stack([keypoints0, keypoints1]))


def pairwise_triangulation(R0, t0, R1, t1, keypoints0, keypoints1):
    """Two-view DLT with a different first pose per row: R0 / t0 (N, 3, 3)
    / (N, 3) world -> camera, R1 / t1 shared (3, 3) / (3,).  Returns
    (points (N, 3), depths (2, N)) as ``two_view_triangulation``."""
    N = keypoints0.shape[0]
    A = torch.cat([_dlt_rows(R0, t0, keypoints0),
                   _dlt_rows(R1.expand(N, 3, 3), t1.expand(N, 3),
                             keypoints1)], dim=1)
    points, degenerate = _dlt_solution(A)
    d0 = dot(R0[:, 2, :], points) + t0[:, 2]
    d1 = dot(points, R1[2]) + t1[2]
    depths = torch.stack([d0, d1])
    return points, torch.where(degenerate[None, :], float("nan"), depths)


def depths_from_triangulation(pose0, pose1, keypoint0, keypoint1):
    """Solve [R0^T y0 | -R1^T y1] d = R0^T t0 - R1^T t1 for (depth0,
    depth1) by the 2x2 normal equations."""
    y0 = to_homogeneous(keypoint0)
    y1 = to_homogeneous(keypoint1)
    A = torch.stack([pose0.R.T @ y0, -(pose1.R.T @ y1)], dim=-1)
    b = pose0.R.T @ pose0.t - pose1.R.T @ pose1.t
    return solve(A.T @ A, A.T @ b)


def compute_depth_mask(depths, min_depth=0.0):
    """Mask of the points in front of every view."""
    return torch.all(depths > min_depth, dim=0)


def depth_condition(depth_mask, positive_depth_ratio=0.8):
    """True when at least ``positive_depth_ratio`` of the points are in
    front of every view."""
    return torch.mean(depth_mask.float()) >= positive_depth_ratio
