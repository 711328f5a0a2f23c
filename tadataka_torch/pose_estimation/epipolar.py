"""Two-view relative pose from the essential matrix (counterpart of
``tadataka_tpu/pose_estimation/epipolar.py``): a masked, Hartley-
normalized 8-point fit, the four (R, t) candidates of E and a
cheirality vote by triangulated depths.

The same bits on the CPU and the card: the SVDs and determinants run on
the host (``core/solvers.py``; E's decomposition is one host call), the
masked sums in a fixed order, 3x3 products left to right."""

import torch

from tadataka_torch.core.pose import Pose
from tadataka_torch.core.rounding import (
    as_divisor, fixed_order_sum, matmul_small, norm)
from tadataka_torch.core.solvers import on_host
from tadataka_torch.core.triangulation import linear_triangulation
from tadataka_torch.features.filters import SQRT2, hartley_matrix
from tadataka_torch.features.ransac import (
    default_generator, rank2_nullspace, ransac_fundamental)
from tadataka_torch.utils.timing import probe


def _W(like):
    return torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                        dtype=like.dtype, device=like.device)


def _masked_hartley(points, mask):
    w = mask.to(points.dtype)
    n = torch.clamp(fixed_order_sum(w[None])[0], min=1.0)
    mean = fixed_order_sum((points * w[:, None]).T) / n
    centered = points - mean
    dist = norm(centered) * w
    scale = as_divisor(SQRT2, dist) / (fixed_order_sum(dist[None])[0] / n
                                       + 1e-12)
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
    return matmul_small(matmul_small(T1.T, rank2_nullspace(A)), T0)


def fundamental_to_essential(F, K0, K1=None):
    if K1 is None:
        K1 = K0
    return matmul_small(matmul_small(K1.T, F), K0)


def decompose_essential(E):
    """E -> (R1, R2, t1, t2), the candidate rotations and translations;
    U and V^T are made proper rotations by their determinants' signs.
    One host call (the SVD, its determinants and the 3x3 products)."""
    return on_host(_decompose_essential, E)


def _decompose_essential(E):
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
    Rs = torch.stack([R1A, R1A, R1B, R1B])
    ts = torch.stack([t1a, t1b, t1a, t1b])
    # the four candidates' triangulations in one batch (one host SVD)
    _, depths = linear_triangulation(
        torch.stack([R0.expand(4, 3, 3), Rs], 1),
        torch.stack([t0.expand(4, 3), ts], 1), keypoints.expand(4, -1, -1, -1))
    counts = torch.sum(mask & torch.all(depths > 0.0, dim=1), dim=-1)
    best = torch.argmax(counts)
    probe("cheirality", counts=counts, best=best)
    return Rs[best], ts[best]


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
    candidates = decompose_essential(E)
    probe("essential", inliers=inliers, E=E, R1=candidates[0],
          R2=candidates[1], t1=candidates[2])
    R, t = select_valid_pose(*candidates, keypoints0, keypoints1, inliers)
    probe("essential", R=R, t=t)
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
