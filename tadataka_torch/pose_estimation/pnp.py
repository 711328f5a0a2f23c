"""Perspective-n-Point pose with RANSAC (counterpart of
``tadataka_tpu/pose_estimation/pnp.py``): fixed-trial RANSAC over EPnP,
P3P or 6-point DLT hypotheses, run as one batch, then a masked
Gauss-Newton refinement on the inliers.  Keypoints are NORMALIZED image
coordinates.  A Gauss-Newton step's normal equations, with the Jacobian
in closed form, are one CUDA kernel on the card (``pnp_normal``).

The same bits on the CPU and the card: the fits' factorizations and the
Gauss-Newton's 6x6 solves, with each step's rotation and pose update,
run on the host (``core/solvers.py``; one host synchronization a
Gauss-Newton step), products of small matrices and norms sum left to
right, the normal equations' sums over the points pairwise in a fixed
order (``core/rounding.py``), which the kernel repeats."""

from pathlib import Path

import numpy as np
import torch

from tadataka_torch.core.pose import Pose
from tadataka_torch.core.projection import EPSILON, pi
from tadataka_torch.core.rounding import (
    fixed_order_sum, matmul_small, norm, sqrt, sum_small)
from tadataka_torch.core.so3 import exp_so3
from tadataka_torch.core.solvers import on_host, solve_nullspace
from tadataka_torch.device import resolve_device, upload
from tadataka_torch.features.ransac import (
    _sample_valid_indices, default_generator, take_rows, uniform_draws)
from tadataka_torch.utils.exceptions import NotEnoughInliersException
from tadataka_torch.utils.timing import count, probe, span

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


def pnp_jacobian(R, t, points, keypoints):
    """The reprojection residuals r (B, 2n) of the pose (exp(p[:3]) R, t +
    p[3:]) at p = 0 and their Jacobian J (B, 2n, 6) in p, point i's x in
    row 2i and its y in row 2i + 1: R (B, 3, 3), t (B, 3), points (B, n,
    3), keypoints (B, n, 2).

    In closed form, in the order that gives the bits of
    ``torch.func.jacfwd``: Y = R X summed left to right, P = Y + t, z =
    P_z + EPSILON, u = P_xy / z, and each column's dP (-[Y]_x for the
    rotation, I for the translation) becomes du = (dP_xy - dP_z u) / z."""
    B, n = points.shape[:2]
    Y = matmul_small(points, R.transpose(-1, -2))
    P = Y + t[:, None, :]
    z = P[..., 2:3] + EPSILON
    u = P[..., :2] / z
    y0, y1, y2 = Y.unbind(-1)
    zero, one = torch.zeros_like(y0), torch.ones_like(y0)
    # dP (B, n, 6, 3) of the increment (w_x, w_y, w_z, t_x, t_y, t_z)
    dP = torch.stack([
        torch.stack([zero, -y2, y1], -1), torch.stack([y2, zero, -y0], -1),
        torch.stack([-y1, y0, zero], -1), torch.stack([one, zero, zero], -1),
        torch.stack([zero, one, zero], -1),
        torch.stack([zero, zero, one], -1)], -2)
    du = (dP[..., :2] - dP[..., 2:3] * u[:, :, None, :]) / z[:, :, None, :]
    return (u - keypoints).reshape(B, 2 * n), du.transpose(-1, -2).reshape(
        B, 2 * n, 6)


def pnp_normal_reference(R, t, points, keypoints, weights):
    """[J^T W J | J^T W r] (B, 6, 7) of :func:`pnp_jacobian`'s r and J,
    weights (B, n) a point.  Plain PyTorch version of the kernel
    ``pnp_normal``.  Each of the 42 products (J_a w) J_b and (J_a w) r is
    its own rounding (the matrix is not mirrored), summed over the 2n
    rows by ``fixed_order_sum``."""
    r, J = pnp_jacobian(R, t, points, keypoints)
    w = weights.repeat_interleave(2, -1)
    Jw = (J * w[..., None]).transpose(-1, -2)           # (B, 6, 2n)
    return fixed_order_sum(Jw[:, :, None, :] * torch.cat(
        [J.transpose(-1, -2), r[:, None, :]], 1)[:, None, :, :])


_PNP_SOURCE = Path(__file__).parent / "csrc" / "pnp_normal.cu"
_pnp_library = None


def pnp_normal_library():
    """Build (at first use) and load the normal-equation kernel."""
    global _pnp_library
    if _pnp_library is None:
        import ctypes
        from tadataka_torch.cuda_build import build
        built = build(_PNP_SOURCE)
        ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
        built.lib.pnp_normal_launch.argtypes = [ptr] * 5 + [i64] * 2 + [
            ptr] * 2
        built.lib.pnp_normal_launch.restype = ctypes.c_int
        _pnp_library = built
    return _pnp_library


def _check_normal_inputs(R, t, points, keypoints, weights):
    if points.dim() != 3 or points.shape[-1] != 3:
        raise ValueError(f"pnp_normal wants points (B, n, 3), got "
                         f"{tuple(points.shape)}")
    B, n = points.shape[:2]
    for name, x, shape in (("R", R, (B, 3, 3)), ("t", t, (B, 3)),
                           ("keypoints", keypoints, (B, n, 2)),
                           ("weights", weights, (B, n))):
        if tuple(x.shape) != shape:
            raise ValueError(f"pnp_normal: {name} is {tuple(x.shape)}, "
                             f"wants {shape}")
    for name, x in (("R", R), ("t", t), ("points", points),
                    ("keypoints", keypoints), ("weights", weights)):
        if x.dtype != torch.float32:
            raise TypeError(f"pnp_normal: {name} must be float32, got "
                            f"{x.dtype}")
        if x.device != points.device:
            raise ValueError(f"pnp_normal: {name} is on {x.device}, "
                             f"points on {points.device}")


def pnp_normal(R, t, points, keypoints, weights):
    """[J^T W J | J^T W r] (B, 6, 7) of one Gauss-Newton step (see
    :func:`pnp_normal_reference`).  A CUDA tensor launches the
    hand-written kernel (csrc/pnp_normal.cu), which gives the plain
    version's bits; a CPU tensor runs the plain version.  No fallback:
    any other device, a non-contiguous input or a failed launch (the
    launcher refuses B or n out of its range) raises.  Each launch is
    counted as "pnp.normal_kernel"."""
    _check_normal_inputs(R, t, points, keypoints, weights)
    if points.device.type == "cpu":
        return pnp_normal_reference(R, t, points, keypoints, weights)
    if points.device.type != "cuda":
        raise ValueError(f"pnp_normal: no kernel for device {points.device}")
    B, n = points.shape[:2]
    args = (R, t, points, keypoints, weights)
    if not all(x.is_contiguous() for x in args):
        raise ValueError("pnp_normal: inputs must be contiguous")
    out = torch.empty((B, 6, 7), dtype=torch.float32, device=points.device)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = pnp_normal_library().lib.pnp_normal_launch(
            *(x.data_ptr() for x in args), B, n, out.data_ptr(), stream)
    if status != 0:
        raise RuntimeError(f"pnp_normal kernel launch failed: CUDA error "
                           f"{status}")
    count("pnp.normal_kernel")
    return out


def _refine_gauss_newton(R, t, points, keypoints, weights, n_iter):
    """Masked Gauss-Newton on (rotvec increment, t) minimizing the
    reprojection error: R (..., 3, 3), t (..., 3), points (..., n, 3),
    keypoints (..., n, 2), weights (..., n).  A step is one
    :func:`pnp_normal` and one host call (:func:`_step`)."""
    batch = torch.broadcast_shapes(R.shape[:-2], points.shape[:-2],
                                   keypoints.shape[:-2], weights.shape[:-1])
    n = points.shape[-2]
    R = R.expand(batch + (3, 3)).reshape(-1, 3, 3).contiguous()
    t = t.expand(batch + (3,)).reshape(-1, 3).contiguous()
    points = points.expand(batch + (n, 3)).reshape(-1, n, 3).contiguous()
    keypoints = keypoints.expand(batch + (n, 2)).reshape(-1, n,
                                                         2).contiguous()
    w = weights.expand(batch + (n,)).reshape(-1, n).contiguous()
    for _ in range(n_iter):
        normal = pnp_normal(R, t, points, keypoints, w)
        delta, R, t = on_host(_step, normal, R, t)
        probe("Gauss-Newton", delta=delta, R=R, t=t)
    return R.reshape(batch + (3, 3)), t.reshape(batch + (3,))


def _step(normal, R, t):
    """The increment delta = -(J^T W J + 1e-9 I)^-1 J^T W r and the pose
    (exp_so3(delta[:3]) R, t + delta[3:]) it takes, on the host, where
    the solve's result is (the same bits as on the card,
    ``core/so3.py``)."""
    eye = 1e-9 * torch.eye(6, dtype=normal.dtype, device=normal.device)
    delta = torch.linalg.solve_ex(normal[..., :6] + eye, -normal[..., 6])[0]
    return (delta, matmul_small(exp_so3(delta[:, :3]), R),
            t + delta[:, 3:])


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
    with span("Gauss-Newton"):
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
