"""EPnP, Efficient Perspective-n-Point (Lepetit, Moreno-Noguer and Fua,
IJCV 2009) (counterpart of ``tadataka_tpu/pose_estimation/epnp.py``).

Fixed-shape linear algebra: one solve for the barycentric coordinates,
one symmetric eigendecomposition for the camera-frame control points and
a Kabsch alignment for (R, t).  The general (4 control points) and planar
(3) layouts, each with the beta cases N=1 and N=2, run unconditionally and
the lowest mean reprojection error wins, so a batch of RANSAC samples runs
as one.  Batched over leading dims; keypoints are normalized.
"""

import torch

from tadataka_torch.core.projection import pi
from tadataka_torch.core.solvers import solve

_EPS = 1e-12


def _kabsch(P_world, P_cam):
    """Rigid (R, t) minimizing ||R p_w + t - p_c||^2 (no scale)."""
    mean_w = torch.mean(P_world, dim=-2)
    mean_c = torch.mean(P_cam, dim=-2)
    S = (P_world - mean_w[..., None, :]).transpose(-1, -2) @ (
        P_cam - mean_c[..., None, :])
    U, _, VT = torch.linalg.svd(S)
    V, Ut = VT.transpose(-1, -2), U.transpose(-1, -2)
    d = torch.sign(torch.linalg.det(V @ Ut))
    D = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    R = (V * D[..., None, :]) @ Ut
    return R, mean_c - (R @ mean_w[..., None])[..., 0]


def _solve_control_points(alphas, keypoints, n_ctrl):
    """The two smallest-eigenvalue null vectors (..., 2, n_ctrl, 3) of the
    EPnP M^T M, for barycentric coords alphas (..., n, n_ctrl)."""
    u = keypoints[..., 0:1]
    v = keypoints[..., 1:2]
    zeros = torch.zeros_like(alphas)
    # rows [a_j, 0, -a_j u] and [0, a_j, -a_j v] per control point j
    rows_x = torch.stack([alphas, zeros, -alphas * u], dim=-1)
    rows_y = torch.stack([zeros, alphas, -alphas * v], dim=-1)
    M = torch.cat([rows_x.flatten(-2), rows_y.flatten(-2)], dim=-2)
    _, V = torch.linalg.eigh(M.transpose(-1, -2) @ M)
    return V[..., :, :2].transpose(-1, -2).reshape(
        V.shape[:-2] + (2, n_ctrl, 3))


def _pair_differences(x, n):
    iu, ju = torch.triu_indices(n, n, offset=1, device=x.device)
    return x[..., iu, :] - x[..., ju, :]


def _beta_n2(ctrl_w, v1, v2):
    """Beta case N=2: solve the linearized pairwise-distance system for
    [b11, b12, b22] = [b1^2, b1 b2, b2^2] and recover (b1, b2)."""
    n = ctrl_w.shape[-2]
    dw = _pair_differences(ctrl_w, n)
    d1 = _pair_differences(v1, n)
    d2 = _pair_differences(v2, n)
    L = torch.stack([torch.sum(d1 * d1, -1), 2.0 * torch.sum(d1 * d2, -1),
                     torch.sum(d2 * d2, -1)], dim=-1)
    rho = torch.sum(dw * dw, -1)
    Lt = L.transpose(-1, -2)
    eye = _EPS * torch.eye(3, dtype=L.dtype, device=L.device)
    b = solve(Lt @ L + eye, (Lt @ rho[..., None])[..., 0])
    # b1 >= 0; b2 carries the sign of b1 b2
    b1 = torch.sqrt(torch.clamp(b[..., 0], min=0.0))
    b2 = torch.sqrt(torch.clamp(b[..., 2], min=0.0)) * torch.where(
        b[..., 1] < 0, -1.0, 1.0)
    return b1[..., None, None] * v1 + b2[..., None, None] * v2


def _scale_and_sign(ctrl_w, ctrl_c, alphas):
    """The null vector's scale (pairwise-distance ratio, beta case N=1) and
    sign (the points in front)."""
    n = ctrl_w.shape[-2]
    nw = torch.linalg.vector_norm(_pair_differences(ctrl_w, n), dim=-1)
    nc = torch.linalg.vector_norm(_pair_differences(ctrl_c, n), dim=-1)
    beta = torch.sum(nc * nw, -1) / (torch.sum(nc * nc, -1) + _EPS)
    ctrl_c = beta[..., None, None] * ctrl_c
    z = (alphas @ ctrl_c)[..., 2]
    flip = torch.sum(torch.sign(z), -1) < 0
    return torch.where(flip[..., None, None], -ctrl_c, ctrl_c)


def _mean_reprojection_error(R, t, points, keypoints):
    P = points @ R.transpose(-1, -2) + t[..., None, :]
    err = torch.linalg.vector_norm(pi(P) - keypoints, dim=-1)
    err = torch.mean(torch.where(P[..., 2] <= 0, 1e6, err), dim=-1)
    # a degenerate layout (the general one on an exactly planar scene)
    # must not win the argmin with NaN
    return torch.where(torch.isfinite(err), err, 1e9)


def _epnp_candidates(ctrl_w, alphas, points, keypoints):
    """(R, t, err) for the beta cases N=1 and N=2 of one control layout."""
    vs = _solve_control_points(alphas, keypoints, ctrl_w.shape[-2])
    out = []
    for ctrl_c in (vs[..., 0, :, :],
                   _beta_n2(ctrl_w, vs[..., 0, :, :], vs[..., 1, :, :])):
        ctrl_c = _scale_and_sign(ctrl_w, ctrl_c, alphas)
        R, t = _kabsch(points, alphas @ ctrl_c)
        out.append((R, t, _mean_reprojection_error(R, t, points, keypoints)))
    return out


def _centered_covariance(points):
    n = points.shape[-2]
    c0 = torch.mean(points, dim=-2)
    X = points - c0[..., None, :]
    return c0, X, X.transpose(-1, -2) @ X / n


def _epnp_general(points, keypoints):
    """4 control points: the centroid and the scaled principal axes."""
    c0, _, cov = _centered_covariance(points)
    w, V = torch.linalg.eigh(cov)  # ascending
    # guard degenerate axes so that the barycentric system stays
    # invertible; the planar layout handles flat scenes
    scale = torch.sqrt(torch.maximum(w, 1e-6 * (w[..., 2:3] + _EPS)))
    ctrl_w = torch.cat([c0[..., None, :], c0[..., None, :]
                        + scale[..., :, None] * V.transpose(-1, -2)], dim=-2)
    C = torch.cat([ctrl_w.transpose(-1, -2),
                   ctrl_w.new_ones(ctrl_w.shape[:-2] + (1, 4))], dim=-2)
    Pext = torch.cat([points.transpose(-1, -2),
                      torch.ones_like(points[..., :1].transpose(-1, -2))],
                     dim=-2)
    alphas = solve(C, Pext).transpose(-1, -2)
    return _epnp_candidates(ctrl_w, alphas, points, keypoints)


def _epnp_planar(points, keypoints):
    """3 control points (the centroid and two in-plane axes) for flat
    scenes."""
    c0, X, cov = _centered_covariance(points)
    w, V = torch.linalg.eigh(cov)
    # the two largest principal axes span the plane
    a1 = torch.sqrt(torch.clamp(w[..., 2:3], min=_EPS)) * V[..., :, 2]
    a2 = torch.sqrt(torch.clamp(w[..., 1:2], min=_EPS)) * V[..., :, 1]
    ctrl_w = torch.stack([c0, c0 + a1, c0 + a2], dim=-2)
    # in-plane coordinates: p = c0 + b1 a1 + b2 a2
    B = torch.stack([a1, a2], dim=-1)
    Bt = B.transpose(-1, -2)
    eye = _EPS * torch.eye(2, dtype=B.dtype, device=B.device)
    coeff = solve(Bt @ B + eye,
                               Bt @ X.transpose(-1, -2)).transpose(-1, -2)
    alphas = torch.cat([1.0 - coeff[..., 0:1] - coeff[..., 1:2], coeff],
                       dim=-1)
    return _epnp_candidates(ctrl_w, alphas, points, keypoints)


def epnp_pose(points, keypoints):
    """EPnP from n >= 5 correspondences (..., n, 3) world and (..., n, 2)
    normalized.  Returns (R, t): of the four candidates (general and
    planar layouts x beta cases N=1 and N=2), the one with the lowest
    mean reprojection error (the first among equal ones).  Camera-frame
    points are ``alphas @ ctrl_c``, aligned to the world points by
    Kabsch."""
    cands = _epnp_general(points, keypoints) + _epnp_planar(points,
                                                            keypoints)
    Rs = torch.stack([c[0] for c in cands], dim=-3)
    ts = torch.stack([c[1] for c in cands], dim=-2)
    best = torch.argmin(torch.stack([c[2] for c in cands], dim=-1), dim=-1)
    R = torch.gather(Rs, -3, best[..., None, None, None].expand(
        best.shape + (1, 3, 3)))[..., 0, :, :]
    t = torch.gather(ts, -2, best[..., None, None].expand(
        best.shape + (1, 3)))[..., 0, :]
    return R, t
