"""Two-view relative pose from the essential matrix (counterpart of
``tadataka_tpu/pose_estimation/epipolar.py``): a masked, Hartley-
normalized 8-point fit, the four (R, t) candidates of E and a
cheirality vote by triangulated depths."""

import torch

from tadataka_torch.core.pose import Pose
from tadataka_torch.core.rounding import as_divisor
from tadataka_torch.core.solvers import solve_nullspace
from tadataka_torch.core.triangulation import linear_triangulation
from tadataka_torch.features.filters import SQRT2, hartley_matrix
from tadataka_torch.features.ransac import (
    default_generator, ransac_fundamental, rank2)


def _W(like):
    return torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                        dtype=like.dtype, device=like.device)


def _masked_hartley(points, mask):
    w = mask.to(points.dtype)
    n = torch.clamp(torch.sum(w), min=1.0)
    mean = torch.sum(points * w[:, None], dim=0) / n
    centered = points - mean
    dist = torch.linalg.vector_norm(centered, dim=1) * w
    scale = as_divisor(SQRT2, dist) / (torch.sum(dist) / n + 1e-12)
    return centered * scale, hartley_matrix(scale, mean)


def estimate_fundamental(keypoints0, keypoints1, mask=None):
    """Masked, Hartley-normalized least-squares 8-point fundamental
    matrix; on normalized image coordinates, the essential matrix."""
    if mask is None:
        mask = torch.ones(keypoints0.shape[0], dtype=torch.bool,
                          device=keypoints0.device)
    p0, T0 = _masked_hartley(keypoints0, mask)
    p1, T1 = _masked_hartley(keypoints1, mask)
    x0, y0 = p0[:, 0], p0[:, 1]
    x1, y1 = p1[:, 0], p1[:, 1]
    A = torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1,
                     x0, y0, torch.ones_like(x0)], dim=-1)
    A = A * mask.to(A.dtype)[:, None]
    F = rank2(solve_nullspace(A).reshape(3, 3))
    return T1.T @ F @ T0


def fundamental_to_essential(F, K0, K1=None):
    if K1 is None:
        K1 = K0
    return K1.T @ F @ K0


def decompose_essential(E):
    """E -> (R1, R2, t1, t2), the candidate rotations and translations;
    U and V^T are made proper rotations by their determinants' signs."""
    U, _, VH = torch.linalg.svd(E)
    U = torch.where(torch.linalg.det(U) < 0, -U, U)
    VH = torch.where(torch.linalg.det(VH) < 0, -VH, VH)
    W = _W(E)
    R1 = U @ W @ VH
    R2 = U @ W.T @ VH
    Z = torch.diag(torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype,
                                device=E.device))
    S = -U @ W @ Z @ U.T
    t1 = torch.stack([S[2, 1], S[0, 2], S[1, 0]])
    return R1, R2, t1, -t1


def select_valid_pose(R1A, R1B, t1a, t1b, keypoints0, keypoints1, mask=None):
    """Cheirality vote: the candidate (R, t) that puts the most
    triangulated points in front of both cameras wins (the first among
    equal counts)."""
    if mask is None:
        mask = torch.ones(keypoints0.shape[0], dtype=torch.bool,
                          device=keypoints0.device)
    R0 = torch.eye(3, dtype=keypoints0.dtype, device=keypoints0.device)
    t0 = torch.zeros(3, dtype=keypoints0.dtype, device=keypoints0.device)
    keypoints = torch.stack([keypoints0, keypoints1])
    candidates = [(R1A, t1a), (R1A, t1b), (R1B, t1a), (R1B, t1b)]
    counts = []
    for R, t in candidates:
        _, depths = linear_triangulation(torch.stack([R0, R]),
                                         torch.stack([t0, t]), keypoints)
        counts.append(torch.sum(mask & torch.all(depths > 0.0, dim=0)))
    best = torch.argmax(torch.stack(counts))
    return (torch.stack([c[0] for c in candidates])[best],
            torch.stack([c[1] for c in candidates])[best])


def estimate_pose_change_lstsq(keypoints0, keypoints1, mask=None):
    """All-inlier least-squares variant: sensitive to structured noise."""
    E = estimate_fundamental(keypoints0, keypoints1, mask)
    R, t = select_valid_pose(*decompose_essential(E), keypoints0, keypoints1,
                             mask)
    return Pose(R, t)


def _estimate_pose_change_ransac(keypoints0, keypoints1, mask, rng,
                                 residual_threshold, n_trials,
                                 site="pose_change"):
    _, inliers = ransac_fundamental(
        keypoints0, keypoints1, mask, rng,
        residual_threshold=residual_threshold, n_trials=n_trials, site=site)
    # refit on the consensus set
    E = estimate_fundamental(keypoints0, keypoints1, inliers)
    R, t = select_valid_pose(*decompose_essential(E), keypoints0, keypoints1,
                             inliers)
    return Pose(R, t), inliers


def estimate_pose_change(keypoints0, keypoints1, mask=None, rng=None,
                         residual_threshold=0.002, n_trials=256):
    """Pose such that x1 = project(pose.R @ X0 + pose.t) up to scale, from
    normalized keypoints: RANSAC, then a refit on the inliers.  ``rng``:
    the draws' source (see ``features/ransac.py``), by default a
    generator seeded with 3939 on the keypoints' device, anew each call
    (the JAX package draws from ``PRNGKey(3939)`` each call)."""
    if mask is None:
        mask = torch.ones(keypoints0.shape[0], dtype=torch.bool,
                          device=keypoints0.device)
    if rng is None:
        rng = default_generator(keypoints0.device)
    pose, _ = _estimate_pose_change_ransac(keypoints0, keypoints1, mask, rng,
                                           residual_threshold, n_trials)
    return pose
