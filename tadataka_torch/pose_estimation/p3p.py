"""P3P: camera pose from three 2D-3D correspondences by Grunert's method
(counterpart of ``tadataka_tpu/pose_estimation/p3p.py``).  Closed form and
branch-free: quartic roots by Ferrari's method with masked discriminant
branches, so a batch of RANSAC samples runs as one.  Batched over leading
dims.

Math: squared side lengths a2 / b2 / c2 between the world points, cosines
of the bearing angles, the distances s_i from the quartic in v = s3 / s1,
and absolute orientation (Kabsch) from the three camera-frame points,
polished by a short Gauss-Newton.
"""

import math

import torch

from tadataka_torch.core.solvers import kabsch_rotation

NEWTON_POLISH_ITERS = 10


def _cbrt(x):
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def _max_real_cubic_root(b, c, d):
    """Largest real root of z^3 + b z^2 + c z + d (branch-free)."""
    p = c - b * b / 3.0
    q = 2.0 * b ** 3 / 27.0 - b * c / 3.0 + d
    off = -b / 3.0
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3

    # disc >= 0: the one real root by Cardano
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    root_pos = _cbrt(-q / 2.0 + sq) + _cbrt(-q / 2.0 - sq)

    # disc < 0: three real roots by the trigonometric method; the largest
    m = torch.sqrt(torch.clamp(-p / 3.0, min=1e-30))
    arg = torch.clamp(3.0 * q / (2.0 * p * m), -1.0, 1.0)
    theta = torch.arccos(arg) / 3.0
    ks = torch.arange(3, dtype=b.dtype, device=b.device)
    roots_trig = 2.0 * m[..., None] * torch.cos(
        theta[..., None] - 2.0 * math.pi * ks / 3.0)
    root_neg = torch.max(roots_trig, dim=-1)[0]
    return torch.where(disc >= 0.0, root_pos, root_neg) + off


def solve_quartic(c4, c3, c2, c1, c0):
    """Real roots of c4 x^4 + ... + c0 (Ferrari) for coefficients (...,).
    Returns (roots (..., 4), valid (..., 4)); invalid lanes hold 0."""
    scale = torch.where(torch.abs(c4) < 1e-20, 1.0, c4)
    p, q, r, s = c3 / scale, c2 / scale, c1 / scale, c0 / scale

    # depressed quartic y^4 + A y^2 + B y + C, x = y - p/4
    A = q - 3.0 * p * p / 8.0
    B = r - p * q / 2.0 + p ** 3 / 8.0
    C = s - p * r / 4.0 + p * p * q / 16.0 - 3.0 * p ** 4 / 256.0

    # the resolvent cubic z^3 + 2A z^2 + (A^2 - 4C) z - B^2 has a root
    # z >= 0, its largest real root
    z = torch.clamp(_max_real_cubic_root(2.0 * A, A * A - 4.0 * C, -B * B),
                    min=0.0)
    w = torch.sqrt(z)
    safe_w = torch.where(w < 1e-12, 1.0, w)
    b_over = torch.where(w < 1e-12, 0.0, B / (2.0 * safe_w))
    half = (A + z) / 2.0

    def quad(b_, c_):
        disc = b_ * b_ - 4.0 * c_
        # a near-double real root can show a slightly negative
        # discriminant in float32: accept it (the Newton polish recentres
        # it; a complex pair does not converge and scores no inliers)
        tol = 1e-4 * (b_ * b_ + torch.abs(4.0 * c_) + 1e-6)
        ok = disc >= -tol
        sd = torch.sqrt(torch.clamp(disc, min=0.0))
        return (torch.stack([(-b_ + sd) / 2.0, (-b_ - sd) / 2.0], dim=-1),
                torch.stack([ok, ok], dim=-1))

    r1, ok1 = quad(w, half - b_over)
    r2, ok2 = quad(-w, half + b_over)
    roots = torch.cat([r1, r2], dim=-1) - (p / 4.0)[..., None]
    valid = torch.cat([ok1, ok2], dim=-1) & (torch.abs(c4) > 1e-20)[..., None]

    # Newton polish on the original quartic
    c4, c3, c2, c1, c0 = (c[..., None] for c in (c4, c3, c2, c1, c0))
    for _ in range(NEWTON_POLISH_ITERS):
        poly = (((c4 * roots + c3) * roots + c2) * roots + c1) * roots + c0
        d = ((4.0 * c4 * roots + 3.0 * c3) * roots + 2.0 * c2) * roots + c1
        roots = roots - poly / torch.where(torch.abs(d) < 1e-20, 1.0, d)
    return torch.where(valid, roots, 0.0), valid


def _kabsch(P_world, Q_cam):
    """R, t with Q = R P + t (no scale; 3 non-collinear points)."""
    cw = torch.mean(P_world, dim=-2)
    cc = torch.mean(Q_cam, dim=-2)
    H = (P_world - cw[..., None, :]).transpose(-1, -2) @ (
        Q_cam - cc[..., None, :])
    R = kabsch_rotation(H)      # the SVD on the host
    return R, cc - (R @ cw[..., None])[..., 0]


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def p3p_solutions(points, keypoints):
    """All P3P solutions of 3 correspondences: points (..., 3, 3) world,
    keypoints (..., 3, 2) normalized.  Returns (Rs (..., 4, 3, 3), ts
    (..., 4, 3), valid (..., 4)) with x_cam = R x_world + t."""
    from tadataka_torch.pose_estimation.pnp import _refine_gauss_newton

    f = torch.cat([keypoints, torch.ones_like(keypoints[..., :1])], dim=-1)
    f = f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)
    P1, P2, P3 = points[..., 0, :], points[..., 1, :], points[..., 2, :]

    a2 = _dot(P2 - P3, P2 - P3)
    b2 = _dot(P1 - P3, P1 - P3)
    c2 = _dot(P1 - P2, P1 - P2)
    ca = _dot(f[..., 1, :], f[..., 2, :])
    cb = _dot(f[..., 0, :], f[..., 2, :])
    cg = _dot(f[..., 0, :], f[..., 1, :])

    # the quartic in v = s3 / s1 (resultant elimination of u = s2 / s1;
    # a common factor b2^2 dropped)
    A4 = (a2 ** 2 - 2 * a2 * b2 - 2 * a2 * c2 + b2 ** 2
          - 4 * b2 * c2 * ca ** 2 + 2 * b2 * c2 + c2 ** 2)
    A3 = -4 * (a2 ** 2 * cb - a2 * b2 * ca * cg - a2 * b2 * cb
               - 2 * a2 * c2 * cb + b2 ** 2 * ca * cg
               - 2 * b2 * c2 * ca ** 2 * cb - b2 * c2 * ca * cg
               + b2 * c2 * cb + c2 ** 2 * cb)
    A2 = 2 * (2 * a2 ** 2 * cb ** 2 + a2 ** 2 - 4 * a2 * b2 * ca * cb * cg
              - 2 * a2 * b2 * cg ** 2 - 4 * a2 * c2 * cb ** 2 - 2 * a2 * c2
              + 2 * b2 ** 2 * ca ** 2 + 2 * b2 ** 2 * cg ** 2 - b2 ** 2
              - 2 * b2 * c2 * ca ** 2 - 4 * b2 * c2 * ca * cb * cg
              + 2 * c2 ** 2 * cb ** 2 + c2 ** 2)
    A1 = -4 * (a2 ** 2 * cb - a2 * b2 * ca * cg - 2 * a2 * b2 * cb * cg ** 2
               + a2 * b2 * cb - 2 * a2 * c2 * cb + b2 ** 2 * ca * cg
               - b2 * c2 * ca * cg - b2 * c2 * cb + c2 ** 2 * cb)
    A0 = (a2 ** 2 - 4 * a2 * b2 * cg ** 2 + 2 * a2 * b2 - 2 * a2 * c2
          + b2 ** 2 - 2 * b2 * c2 + c2 ** 2)

    vs, valid = solve_quartic(A4, A3, A2, A1, A0)
    a2, b2, c2, ca, cb, cg = (x[..., None] for x in (a2, b2, c2, ca, cb, cg))

    # u = s2 / s1 is linear in v
    denom_u = 2.0 * b2 * (cg - vs * ca)
    num_u = b2 * (1.0 - vs ** 2) + (a2 - c2) * (1.0 + vs ** 2 - 2 * vs * cb)
    us = num_u / torch.where(torch.abs(denom_u) < 1e-20, 1.0, denom_u)
    valid = valid & (torch.abs(denom_u) >= 1e-20)

    s1sq_denom = 1.0 + vs ** 2 - 2.0 * vs * cb
    s1 = torch.sqrt(b2 / torch.clamp(s1sq_denom, min=1e-20))
    s2 = us * s1
    s3 = vs * s1
    valid = valid & (s1 > 0) & (s2 > 0) & (s3 > 0) & (s1sq_denom > 1e-20)

    # each solution's camera-frame points, aligned to the world points;
    # near-double roots (v ~ 1, small motions) carry ~sqrt(float32 eps)
    # error, which 5 Gauss-Newton steps on the 3-point reprojection
    # system (6 residuals, 6 dof) remove
    Q = torch.stack([s1, s2, s3], dim=-1)[..., None] * f[..., None, :, :]
    world = points[..., None, :, :].expand(Q.shape)
    R, t = _kabsch(world, Q)
    R, t = _refine_gauss_newton(R, t, world, keypoints[..., None, :, :],
                                torch.ones_like(Q[..., 0]), 5)
    return R, t, valid


def p3p_best_pose(points4, keypoints4):
    """A RANSAC trial: P3P on the first 3 correspondences (..., 4, 3) /
    (..., 4, 2), the solution chosen by the 4th point's reprojection
    error.  Returns (R, t)."""
    Rs, ts, valid = p3p_solutions(points4[..., :3, :], keypoints4[..., :3, :])
    p = (Rs @ points4[..., None, 3, :, None])[..., 0] + ts
    z = p[..., 2]
    proj = p[..., :2] / torch.where(torch.abs(z) < 1e-12, 1e-12, z)[..., None]
    err = torch.sum((proj - keypoints4[..., None, 3, :]) ** 2, dim=-1)
    err = torch.where(valid & (z > 0), err, float("inf"))
    best = torch.argmin(err, dim=-1)
    R = torch.gather(Rs, -3, best[..., None, None, None].expand(
        best.shape + (1, 3, 3)))[..., 0, :, :]
    t = torch.gather(ts, -2, best[..., None, None].expand(
        best.shape + (1, 3)))[..., 0, :]
    return R, t
