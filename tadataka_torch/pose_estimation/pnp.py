"""Perspective-n-Point pose with RANSAC (counterpart of
``tadataka_tpu/pose_estimation/pnp.py``): fixed-trial RANSAC over EPnP,
P3P or 6-point DLT hypotheses, run as one batch, then a masked
Gauss-Newton refinement on the inliers.  Keypoints are NORMALIZED image
coordinates.  The Gauss-Newton Jacobian comes from
``torch.func.jacfwd`` under ``torch.func.vmap`` over the batch.

The same bits on the CPU and the card: the fits' factorizations and the
Gauss-Newton's 6x6 solves, with each step's rotation, run on the host
(``core/solvers.py``; one host synchronization a Gauss-Newton step),
products of small matrices
and norms sum left to right, the normal equations' sums over the
points pairwise in a fixed order (``core/rounding.py``)."""

import numpy as np
import torch

from tadataka_torch.core.pose import Pose
from tadataka_torch.core.projection import pi
from tadataka_torch.core.rounding import (
    fixed_order_sum, matmul_small, norm, sqrt, sum_small)
from tadataka_torch.core.so3 import exp_so3, exp_so3_small
from tadataka_torch.core.solvers import on_host, solve_nullspace
from tadataka_torch.device import resolve_device, upload
from tadataka_torch.features.ransac import (
    _sample_valid_indices, default_generator, take_rows, uniform_draws)
from tadataka_torch.utils.exceptions import NotEnoughInliersException
from tadataka_torch.utils.timing import probe, stage

DEFAULT_TRIALS = 128
MIN_CORRESPONDENCES = 6
EPNP_SAMPLES = 5
GN_ITERATIONS = 15


def calc_reprojection_threshold(keypoints, k=3.0, mask=None):
    """k * rms distance from the centroid / n, over the ``mask``ed rows."""
    if mask is None:
        w = torch.ones(keypoints.shape[0], dtype=keypoints.dtype,
                       device=keypoints.device)
        n = torch.full((), float(keypoints.shape[0]), dtype=keypoints.dtype,
                       device=keypoints.device)
    else:
        w = mask.to(keypoints.dtype)
        n = torch.clamp(torch.sum(w), min=1.0)
    center = fixed_order_sum((keypoints * w[:, None]).T)[None] / n
    sq = sum_small((keypoints - center) ** 2) * w
    rms = sqrt(fixed_order_sum(sq[None])[0] / n)
    return k * rms / n


def _dlt_pose(points, keypoints):
    """DLT camera-matrix fit from n >= 6 correspondences (..., n, 3) and
    (..., n, 2), projected onto SO(3).  Returns (R, t)."""
    X = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    zeros = torch.zeros_like(X)
    x, y = keypoints[..., 0:1], keypoints[..., 1:2]
    A = torch.cat([torch.cat([X, zeros, -x * X], dim=-1),
                   torch.cat([zeros, X, -y * X], dim=-1)], dim=-2)
    P = solve_nullspace(A).reshape(A.shape[:-2] + (3, 4))
    R, scale = on_host(_dlt_rotation, P[..., :3])
    t = P[..., 3] / (scale + 1e-12)[..., None]
    # the global sign that puts the points in front of the camera
    depths = sum_small(points * R[..., None, 2, :]) + t[..., None, 2]
    flip = torch.sum(torch.sign(depths), dim=-1) < 0
    return R, torch.where(flip[..., None], -t, t)


def _dlt_rotation(M):
    """The rotation U diag(1, 1, d) V^T nearest the DLT's M = U s V^T
    (d = sign det(U V^T)) and the scale mean(s) d, on the host."""
    U, s, Vt = torch.linalg.svd(M)
    d = torch.sign(torch.linalg.det(U @ Vt))
    D = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    return (U * D[..., None, :]) @ Vt, torch.mean(s, dim=-1) * d


def _transform(R, t, points):
    return matmul_small(points, R.transpose(-1, -2)) + t[..., None, :]


def _reprojection_errors(R, t, points, keypoints):
    P = _transform(R, t, points)
    err = norm(pi(P) - keypoints)
    return torch.where(P[..., 2] <= 0, float("inf"), err)


def _residuals(p, R, t, points, keypoints):
    """Reprojection residuals (2n,) of the pose (exp(p[:3]) R, t + p[3:])
    for an increment p near 0: its Jacobian is taken at p = 0, where
    ``exp_so3`` takes its small-angle branch, so that branch alone is
    differentiated (the same values and derivatives)."""
    Rk = matmul_small(exp_so3_small(p[:3]), R)
    P = matmul_small(points, Rk.transpose(-1, -2)) + (t + p[3:])
    return (pi(P) - keypoints).reshape(-1)


_jacobians = torch.func.vmap(torch.func.jacfwd(_residuals),
                             in_dims=(None, 0, 0, 0, 0))


def _refine_gauss_newton(R, t, points, keypoints, weights, n_iter):
    """Masked Gauss-Newton on (rotvec increment, t) minimizing the
    reprojection error: R (..., 3, 3), t (..., 3), points (..., n, 3),
    keypoints (..., n, 2), weights (..., n)."""
    batch = torch.broadcast_shapes(R.shape[:-2], points.shape[:-2],
                                   keypoints.shape[:-2], weights.shape[:-1])
    n = points.shape[-2]
    R = R.expand(batch + (3, 3)).reshape(-1, 3, 3)
    t = t.expand(batch + (3,)).reshape(-1, 3)
    points = points.expand(batch + (n, 3)).reshape(-1, n, 3)
    keypoints = keypoints.expand(batch + (n, 2)).reshape(-1, n, 2)
    w = weights.expand(batch + (n,)).reshape(-1, n).repeat_interleave(2, -1)
    zero = torch.zeros(6, dtype=t.dtype, device=t.device)
    eye = 1e-9 * torch.eye(6, dtype=t.dtype, device=t.device)
    for _ in range(n_iter):
        J = _jacobians(zero, R, t, points, keypoints)
        r = (pi(_transform(R, t, points)) - keypoints).reshape(len(R), -1)
        Jw = (J * w[..., None]).transpose(-1, -2)           # (B, 6, 2n)
        # [J^T W J | J^T W r] (B, 6, 7) in one pairwise sum over the rows
        normal = fixed_order_sum(Jw[:, :, None, :] * torch.cat(
            [J.transpose(-1, -2), r[:, None, :]], 1)[:, None, :, :])
        delta, step = on_host(_step, normal[..., :6] + eye, normal[..., 6])
        R = matmul_small(step, R)
        t = t + delta[:, 3:]
        probe("Gauss-Newton", delta=delta, R=R, t=t)
    return R.reshape(batch + (3, 3)), t.reshape(batch + (3,))


def _step(JtJ, Jtr):
    """The increment delta = -(J^T W J)^-1 J^T W r and its rotation
    exp_so3(delta[:3]): on the host, where the solve's result is (the
    same bits as on the card, ``core/so3.py``)."""
    delta = torch.linalg.solve_ex(JtJ, -Jtr)[0]
    return delta, exp_so3(delta[:, :3])


def solve_pnp_ransac(points, keypoints, mask, rng,
                     reprojection_threshold=None, n_trials=DEFAULT_TRIALS,
                     method="epnp", site="pnp"):
    """RANSAC + Gauss-Newton refinement.  Returns (Pose, inlier_mask).

    method: "epnp" (5-point samples), "p3p" (3-point Grunert solver and a
    4th point to choose among its solutions) or "dlt" (6-point DLT)."""
    from tadataka_torch.pose_estimation.epnp import epnp_pose
    from tadataka_torch.pose_estimation.p3p import p3p_best_pose

    if reprojection_threshold is None:
        reprojection_threshold = calc_reprojection_threshold(keypoints,
                                                             mask=mask)
    if method == "epnp":
        fit, n_samples = epnp_pose, EPNP_SAMPLES
    elif method == "p3p":
        fit, n_samples = p3p_best_pose, 4
    elif method == "dlt":
        fit, n_samples = _dlt_pose, MIN_CORRESPONDENCES
    else:
        raise ValueError(f"unknown PnP method: {method}")

    r = uniform_draws(rng, site, (n_trials, n_samples), points.device)
    samples = _sample_valid_indices(r, mask)
    Rs, ts = fit(take_rows(points, samples), take_rows(keypoints, samples))
    err = _reprojection_errors(Rs, ts, points, keypoints)
    counts = torch.sum(mask & (err < reprojection_threshold), dim=-1)
    best = torch.argmax(counts)
    R, t = Rs[best], ts[best]
    probe(f"RANSAC {site}", threshold=reprojection_threshold, Rs=Rs, ts=ts,
          trial_inliers=counts, best=best)

    err = _reprojection_errors(R, t, points, keypoints)
    inliers = mask & (err < reprojection_threshold)
    probe(f"RANSAC {site}", inliers=inliers)
    with stage("Gauss-Newton", points.device):
        R, t = _refine_gauss_newton(R, t, points, keypoints,
                                    inliers.to(points.dtype), GN_ITERATIONS)
    err = _reprojection_errors(R, t, points, keypoints)
    return Pose(R, t), mask & (err < reprojection_threshold)


def solve_pnp(points, keypoints, mask=None, rng=None,
              reprojection_threshold=None):
    """Raises on too few correspondences or an empty consensus, returns the
    Pose.  ``rng``: the draws' source, by default a generator seeded with
    3939 on the points' device, anew each call."""
    if mask is None:
        mask = torch.ones(points.shape[0], dtype=torch.bool,
                          device=points.device)
    if rng is None:
        rng = default_generator(points.device)
    if int(torch.sum(mask)) < MIN_CORRESPONDENCES:
        raise NotEnoughInliersException("No sufficient correspondences")
    pose, inliers = solve_pnp_ransac(
        points, keypoints, mask, rng,
        reprojection_threshold=reprojection_threshold)
    if int(torch.sum(inliers)) == 0:
        raise NotEnoughInliersException("No inliers found")
    return pose


def solve_pnp_packed(points, keypoints, mask_np, rng=None,
                     reprojection_threshold=None, device="cuda"):
    """``solve_pnp`` with no host read: the correspondence count comes from
    the host mask ``mask_np``, and the result is one (13,) device vector
    [R.ravel(), t, n_inliers] for the caller to read at once (a read n_inliers
    of 0 means no inliers).  Raises only on too few correspondences."""
    if int(np.sum(mask_np)) < MIN_CORRESPONDENCES:
        raise NotEnoughInliersException("No sufficient correspondences")
    device = resolve_device(device)
    points = upload(points, device, torch.float32)
    keypoints = upload(keypoints, device, torch.float32)
    mask = upload(np.asarray(mask_np, bool), device)
    if rng is None:
        rng = default_generator(device)
    pose, inliers = solve_pnp_ransac(
        points, keypoints, mask, rng,
        reprojection_threshold=reprojection_threshold)
    return torch.cat([pose.R.reshape(-1), pose.t,
                      torch.sum(inliers).to(torch.float32)[None]])
