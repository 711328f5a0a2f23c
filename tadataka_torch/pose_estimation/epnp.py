"""EPnP, Efficient Perspective-n-Point (Lepetit, Moreno-Noguer and Fua,
IJCV 2009) (counterpart of ``tadataka_tpu/pose_estimation/epnp.py``).

Fixed-shape linear algebra: one solve for the barycentric coordinates,
one symmetric eigendecomposition for the camera-frame control points and
a Kabsch alignment for (R, t).  The general (4 control points) and planar
(3) layouts, each with the beta cases N=1 and N=2, run unconditionally and
the lowest mean reprojection error wins, so a batch of RANSAC samples runs
as one.  Batched over leading dims; keypoints are normalized.

The same bits on the CPU and the card: the eigendecompositions, solves
and the Kabsch SVDs run on the host (``core/solvers.py``), each kind
for both layouts in one host call (five a call of ``epnp_pose``), every
other product and sum in a fixed order (``core/rounding.py``).
"""

import torch

from tadataka_torch.core.projection import pi
from tadataka_torch.core.rounding import (
    as_divisor, fixed_order_sum, matmul_small, mean, norm, sqrt, sum_small)
from tadataka_torch.core.solvers import kabsch_rotation, on_host

_EPS = 1e-12


def _kabsch_cross(P_world, P_cam):
    """The centroids and the cross-covariance S of a rigid alignment
    R p_w + t = p_c."""
    mean_w = mean(P_world, -2)
    mean_c = mean(P_cam, -2)
    S = fixed_order_sum(
        (P_world - mean_w[..., None, :]).transpose(-1, -2)[..., :, None, :]
        * (P_cam - mean_c[..., None, :]).transpose(-1, -2)[..., None, :, :])
    return mean_w, mean_c, S


def _control_system(alphas, keypoints):
    """The EPnP matrix M (..., 2n, 3 n_ctrl) for barycentric coords alphas
    (..., n, n_ctrl): rows [a_j, 0, -a_j u] and [0, a_j, -a_j v]."""
    u = keypoints[..., 0:1]
    v = keypoints[..., 1:2]
    zeros = torch.zeros_like(alphas)
    rows_x = torch.stack([alphas, zeros, -alphas * u], dim=-1)
    rows_y = torch.stack([zeros, alphas, -alphas * v], dim=-1)
    return torch.cat([rows_x.flatten(-2), rows_y.flatten(-2)], dim=-2)


def _gram(M):
    """M^T M (..., k, k) for M (..., m, k), each entry's m products summed
    pairwise in a fixed order."""
    Mt = M.transpose(-1, -2)
    return fixed_order_sum(Mt[..., :, None, :] * Mt[..., None, :, :])


def _pair_differences(x, n):
    iu, ju = torch.triu_indices(n, n, offset=1, device=x.device)
    return x[..., iu, :] - x[..., ju, :]


def _beta_system(ctrl_w, v1, v2):
    """The beta case N=2's normal equations for [b11, b12, b22] = [b1^2,
    b1 b2, b2^2] from the linearized pairwise distances."""
    n = ctrl_w.shape[-2]
    dw = _pair_differences(ctrl_w, n)
    d1 = _pair_differences(v1, n)
    d2 = _pair_differences(v2, n)
    L = torch.stack([sum_small(d1 * d1), 2.0 * sum_small(d1 * d2),
                     sum_small(d2 * d2)], dim=-1)
    rho = sum_small(dw * dw)
    eye = _EPS * torch.eye(3, dtype=L.dtype, device=L.device)
    return _gram(L) + eye, fixed_order_sum(L.transpose(-1, -2)
                                          * rho[..., None, :])


def _beta_n2(b, v1, v2):
    """(b1, b2) from the solved system: b1 >= 0, b2 carrying the sign of
    b1 b2; the control points b1 v1 + b2 v2."""
    b1 = sqrt(torch.clamp(b[..., 0], min=0.0))
    b2 = sqrt(torch.clamp(b[..., 2], min=0.0)) * torch.where(
        b[..., 1] < 0, -1.0, 1.0)
    return b1[..., None, None] * v1 + b2[..., None, None] * v2


def _scale_and_sign(ctrl_w, ctrl_c, alphas):
    """The null vector's scale (pairwise-distance ratio, beta case N=1) and
    sign (the points in front)."""
    n = ctrl_w.shape[-2]
    nw = norm(_pair_differences(ctrl_w, n))
    nc = norm(_pair_differences(ctrl_c, n))
    beta = sum_small(nc * nw) / (sum_small(nc * nc) + _EPS)
    ctrl_c = beta[..., None, None] * ctrl_c
    z = matmul_small(alphas, ctrl_c)[..., 2]
    flip = torch.sum(torch.sign(z), -1) < 0
    return torch.where(flip[..., None, None], -ctrl_c, ctrl_c)


def _mean_reprojection_error(R, t, points, keypoints):
    P = matmul_small(points, R.transpose(-1, -2)) + t[..., None, :]
    err = norm(pi(P) - keypoints)
    err = mean(torch.where(P[..., 2] <= 0, 1e6, err), -1)
    # a degenerate layout (the general one on an exactly planar scene)
    # must not win the argmin with NaN
    return torch.where(torch.isfinite(err), err, 1e9)


def _centered_covariance(points):
    c0 = mean(points, -2)
    X = points - c0[..., None, :]
    cov = _gram(X)
    return c0, X, cov / as_divisor(points.shape[-2], cov)


def _solve_both(A1, B1, A2, B2):
    return (torch.linalg.solve_ex(A1, B1)[0],
            torch.linalg.solve_ex(A2, B2)[0])


def _null_vectors_both(G1, G2):
    """The two smallest-eigenvalue eigenvectors of each Gram matrix."""
    return torch.linalg.eigh(G1)[1][..., :, :2], \
        torch.linalg.eigh(G2)[1][..., :, :2]


def epnp_pose(points, keypoints):
    """EPnP from n >= 5 correspondences (..., n, 3) world and (..., n, 2)
    normalized.  Returns (R, t): of the four candidates (general and
    planar layouts x beta cases N=1 and N=2), the one with the lowest
    mean reprojection error (the first among equal ones).  Camera-frame
    points are ``alphas @ ctrl_c``, aligned to the world points by
    Kabsch.

    The general layout has 4 control points, the centroid and the scaled
    principal axes; the planar one 3, the centroid and the two largest
    axes, for flat scenes.  Both come from one eigendecomposition of the
    points' covariance."""
    c0, X, cov = _centered_covariance(points)
    w, V = on_host(torch.linalg.eigh, cov)  # ascending
    # general: guard degenerate axes so that the barycentric system
    # stays invertible; the planar layout handles flat scenes
    scale = sqrt(torch.maximum(w, 1e-6 * (w[..., 2:3] + _EPS)))
    ctrl_g = torch.cat([c0[..., None, :], c0[..., None, :]
                        + scale[..., :, None] * V.transpose(-1, -2)], dim=-2)
    C = torch.cat([ctrl_g.transpose(-1, -2),
                   ctrl_g.new_ones(ctrl_g.shape[:-2] + (1, 4))], dim=-2)
    Pext = torch.cat([points.transpose(-1, -2),
                      torch.ones_like(points[..., :1].transpose(-1, -2))],
                     dim=-2)
    # planar: in-plane coordinates, p = c0 + b1 a1 + b2 a2
    a1 = sqrt(torch.clamp(w[..., 2:3], min=_EPS)) * V[..., :, 2]
    a2 = sqrt(torch.clamp(w[..., 1:2], min=_EPS)) * V[..., :, 1]
    ctrl_p = torch.stack([c0, c0 + a1, c0 + a2], dim=-2)
    B = torch.stack([a1, a2], dim=-1)
    eye = _EPS * torch.eye(2, dtype=B.dtype, device=B.device)
    alphas_g, coeff = on_host(_solve_both, C, Pext, _gram(B) + eye,
                              matmul_small(B.transpose(-1, -2),
                                           X.transpose(-1, -2)))
    alphas_g = alphas_g.transpose(-1, -2)
    coeff = coeff.transpose(-1, -2)
    alphas_p = torch.cat([1.0 - coeff[..., 0:1] - coeff[..., 1:2], coeff],
                         dim=-1)
    layouts = ((ctrl_g, alphas_g), (ctrl_p, alphas_p))

    nulls = on_host(_null_vectors_both, *(
        _gram(_control_system(alphas, keypoints)) for _, alphas in layouts))
    vs = [N.transpose(-1, -2).reshape(N.shape[:-2] + (2, ctrl.shape[-2], 3))
          for N, (ctrl, _) in zip(nulls, layouts)]
    systems = [_beta_system(ctrl, v[..., 0, :, :], v[..., 1, :, :])
               for v, (ctrl, _) in zip(vs, layouts)]
    betas = on_host(_solve_both, *systems[0], *systems[1])

    centroids, crosses = [], []
    for (ctrl, alphas), v, b in zip(layouts, vs, betas):
        for ctrl_c in (v[..., 0, :, :],
                       _beta_n2(b, v[..., 0, :, :], v[..., 1, :, :])):
            ctrl_c = _scale_and_sign(ctrl, ctrl_c, alphas)
            mean_w, mean_c, S = _kabsch_cross(points,
                                              matmul_small(alphas, ctrl_c))
            centroids.append((mean_w, mean_c))
            crosses.append(S)
    Rs = kabsch_rotation(torch.stack(crosses, dim=-3))   # (..., 4, 3, 3)
    ts = torch.stack([mean_c - matmul_small(Rs[..., i, :, :],
                                            mean_w[..., None])[..., 0]
                      for i, (mean_w, mean_c) in enumerate(centroids)],
                     dim=-2)
    errs = torch.stack([_mean_reprojection_error(
        Rs[..., i, :, :], ts[..., i, :], points, keypoints)
        for i in range(4)], dim=-1)
    best = torch.argmin(errs, dim=-1)
    R = torch.gather(Rs, -3, best[..., None, None, None].expand(
        best.shape + (1, 3, 3)))[..., 0, :, :]
    t = torch.gather(ts, -2, best[..., None, None].expand(
        best.shape + (1, 3)))[..., 0, :]
    return R, t
