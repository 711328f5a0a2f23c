"""Plain forms of VITAMIN-E's back end as the repository runs it, for
the reference: the essential-matrix bootstrap (a RANSAC over normalized
8-point fits, the least-squares refit on its inliers, the four
decompositions and the cheirality vote), PnP (a RANSAC over EPnP
hypotheses, then a Gauss-Newton refinement on the inliers) and the
two-view DLT triangulation.

Written from the published methods (Hartley and Zisserman, chapters 9
and 12; Lepetit, Moreno-Noguer and Fua, IJCV 2009) and the JAX
package's choices, in direct vectorised PyTorch, float32, on the
tensors' device: factorizations by ``torch.linalg`` where the tensors
are, sums by ``torch.sum``, the Gauss-Newton Jacobian written out
analytically (the JAX package and the port differentiate the residual
automatically).

The JAX package's choices kept: 256 trials at 0.002 (normalized
coordinates, the root of the Sampson distance) for the essential
matrix, the candidates in the order (R1, t), (R1, -t), (R2, t),
(R2, -t), the first with the most points in front of both cameras;
EPnP's two layouts (four control points on the principal axes, and
three on the two largest for flat scenes) with beta cases N=1 and N=2,
the lowest mean reprojection error winning, a point behind the camera
counting 1e6; 128 PnP trials of 5 points; 15 Gauss-Newton steps with
1e-9 damping on a rotation increment applied on the left; a point
written where its depth is positive in both views.
"""

import torch

from bench_port.reference.plain_features import (
    epipolar_rows, masked_hartley, null_vector, sample_indices, sampson,
    eight_point)


def hat(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def rodrigues(w):
    """exp of so(3) (..., 3) -> (..., 3, 3)."""
    theta = w.norm(dim=-1)[..., None, None]
    K = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    small = theta < 1e-6
    safe = torch.where(small, 1.0, theta)
    a = torch.where(small, 1.0 - theta ** 2 / 6.0, torch.sin(safe) / safe)
    b = torch.where(small, 0.5 - theta ** 2 / 24.0,
                    (1.0 - torch.cos(safe)) / (safe * safe))
    return eye + a * K + b * (K @ K)


def project(R, t, X):
    P = X @ R.transpose(-1, -2) + t[..., None, :]
    return P[..., :2] / (P[..., 2:] + 1e-16), P[..., 2]


# ------------------------------------------------------------ two views

def triangulate(R0, t0, R1, t1, x0, x1):
    """Two-view DLT: each row against its own first pose R0 / t0 (N, 3,
    3) / (N, 3) and the shared second R1 / t1.  Returns (points (N, 3),
    in front of both (N,))."""
    def rows(R, t, x):
        A = x[..., :, None] * R[..., None, 2, :] - R[..., :2, :]
        b = x * t[..., None, 2] - t[..., :2]
        return torch.cat([A, b[..., None]], -1)
    N = len(x0)
    A = torch.cat([rows(R0, t0, x0),
                   rows(R1.expand(N, 3, 3), t1.expand(N, 3), x1)], 1)
    X = torch.linalg.svd(A)[2][:, -1]
    w = X[:, 3]
    degenerate = w.abs() < 1e-12
    points = X[:, :3] / torch.where(degenerate, 1.0, w)[:, None]
    points = torch.where(degenerate[:, None], float("inf"), points)
    d0 = (R0[:, 2] * points).sum(-1) + t0[:, 2]
    d1 = points @ R1[2] + t1[2]
    front = (d0 > 0) & (d1 > 0) & torch.isfinite(points).all(-1)
    return points, front


def essential_refit(x0, x1, mask):
    """The masked, normalized least-squares 8-point fit, rank 2."""
    p0, T0 = masked_hartley(x0, mask, 1e-12)
    p1, T1 = masked_hartley(x1, mask, 1e-12)
    A = epipolar_rows(p0, p1) * mask.float()[:, None]
    U, s, Vh = torch.linalg.svd(null_vector(A).reshape(3, 3))
    E = U @ torch.diag(torch.stack([s[0], s[1], torch.zeros_like(s[0])])
                       ) @ Vh
    return T1.T @ E @ T0


def decompose(E):
    U, _, Vh = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vh = Vh * torch.sign(torch.linalg.det(Vh))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     device=E.device)
    S = -U @ W @ torch.diag(torch.tensor([1.0, 1.0, 0.0],
                                         device=E.device)) @ U.T
    t = torch.stack([S[2, 1], S[0, 2], S[1, 0]])
    return U @ W @ Vh, U @ W.T @ Vh, t


def essential_trials(x0, x1, draws):
    """Each RANSAC trial's inliers (the root of the Sampson distance
    under 0.002) on normalized matches."""
    samples = sample_indices(draws, torch.ones(len(x0), dtype=torch.bool,
                                               device=x0.device))
    Fs = eight_point(x0[samples], x1[samples])
    return (torch.sqrt(sampson(Fs, x0[None], x1[None])) < 0.002).sum(-1)


def bootstrap_refit(x0, x1, inliers):
    """The pose (R, t) of frame 1, frame 0 at the origin, from the
    RANSAC's inliers: the refit, its four decompositions and the
    cheirality vote."""
    R1, R2, t = decompose(essential_refit(x0, x1, inliers))
    eye = torch.eye(3, device=x0.device)
    zero = torch.zeros(3, device=x0.device)
    best_count, best_pose = -1, None
    for R, tc in ((R1, t), (R1, -t), (R2, t), (R2, -t)):
        _, front = triangulate(eye.expand(len(x0), 3, 3),
                               zero.expand(len(x0), 3), R, tc, x0, x1)
        n = int((front & inliers).sum())
        if n > best_count:
            best_count, best_pose = n, (R, tc)
    return best_pose


# ------------------------------------------------------------ PnP

def kabsch(Pw, Pc):
    """R, t with Pc ~ R Pw + t."""
    mw, mc = Pw.mean(-2), Pc.mean(-2)
    S = (Pw - mw[..., None, :]).transpose(-1, -2) @ (Pc - mc[..., None, :])
    U, _, Vh = torch.linalg.svd(S)
    V, Ut = Vh.transpose(-1, -2), U.transpose(-1, -2)
    d = torch.sign(torch.linalg.det(V @ Ut))
    D = torch.diag_embed(torch.stack([torch.ones_like(d),
                                      torch.ones_like(d), d], -1))
    R = V @ D @ Ut
    return R, mc - (R @ mw[..., None])[..., 0]


def pair_differences(x):
    i, j = torch.triu_indices(x.shape[-2], x.shape[-2], 1, device=x.device)
    return x[..., i, :] - x[..., j, :]


def epnp(points, keypoints, eps=1e-12):
    """EPnP of (..., n, 3) world points and (..., n, 2) normalized
    keypoints: the best of four candidates by mean reprojection
    error."""
    c0 = points.mean(-2)
    X = points - c0[..., None, :]
    w, V = torch.linalg.eigh(X.transpose(-1, -2) @ X / points.shape[-2])
    scale = torch.sqrt(torch.maximum(w, 1e-6 * (w[..., 2:3] + eps)))
    ctrl_g = torch.cat([c0[..., None, :], c0[..., None, :]
                        + scale[..., :, None] * V.transpose(-1, -2)], -2)
    C = torch.cat([ctrl_g.transpose(-1, -2),
                   torch.ones_like(ctrl_g[..., None, :, 0])], -2)  # (.., 4, 4)
    Ph = torch.cat([points, torch.ones_like(points[..., :1])], -1)
    alphas_g = torch.linalg.solve(C, Ph.transpose(-1, -2)).transpose(-1, -2)
    a1 = torch.sqrt(w[..., 2:3].clamp(min=eps)) * V[..., :, 2]
    a2 = torch.sqrt(w[..., 1:2].clamp(min=eps)) * V[..., :, 1]
    ctrl_p = torch.stack([c0, c0 + a1, c0 + a2], -2)
    B = torch.stack([a1, a2], -1)                               # (.., 3, 2)
    coeff = torch.linalg.solve(
        B.transpose(-1, -2) @ B + eps * torch.eye(2, device=B.device),
        B.transpose(-1, -2) @ X.transpose(-1, -2)).transpose(-1, -2)
    alphas_p = torch.cat([1.0 - coeff.sum(-1, keepdim=True), coeff], -1)

    candidates = []
    u, v = keypoints[..., 0:1], keypoints[..., 1:2]
    for ctrl, alphas in ((ctrl_g, alphas_g), (ctrl_p, alphas_p)):
        m = ctrl.shape[-2]
        zeros = torch.zeros_like(alphas)
        M = torch.cat([
            torch.stack([alphas, zeros, -alphas * u], -1).flatten(-2),
            torch.stack([zeros, alphas, -alphas * v], -1).flatten(-2)], -2)
        nulls = torch.linalg.eigh(M.transpose(-1, -2) @ M)[1][..., :, :2]
        v1 = nulls[..., :, 0].reshape(nulls.shape[:-2] + (m, 3))
        v2 = nulls[..., :, 1].reshape(nulls.shape[:-2] + (m, 3))
        dw, d1, d2 = (pair_differences(x) for x in (ctrl, v1, v2))
        L = torch.stack([(d1 * d1).sum(-1), 2.0 * (d1 * d2).sum(-1),
                         (d2 * d2).sum(-1)], -1)
        rho = (dw * dw).sum(-1)
        b = torch.linalg.solve(
            L.transpose(-1, -2) @ L + eps * torch.eye(3, device=L.device),
            (L.transpose(-1, -2) @ rho[..., None]))[..., 0]
        b1 = torch.sqrt(b[..., 0].clamp(min=0.0))
        b2 = torch.sqrt(b[..., 2].clamp(min=0.0)) * torch.where(
            b[..., 1] < 0, -1.0, 1.0)
        for ctrl_c in (v1, b1[..., None, None] * v1
                       + b2[..., None, None] * v2):
            nw = pair_differences(ctrl).norm(dim=-1)
            nc = pair_differences(ctrl_c).norm(dim=-1)
            beta = (nc * nw).sum(-1) / ((nc * nc).sum(-1) + eps)
            ctrl_c = beta[..., None, None] * ctrl_c
            z = (alphas @ ctrl_c)[..., 2]
            flip = torch.sign(z).sum(-1) < 0
            ctrl_c = torch.where(flip[..., None, None], -ctrl_c, ctrl_c)
            candidates.append(kabsch(points, alphas @ ctrl_c))
    errors = []
    for R, t in candidates:
        x, z = project(R, t, points)
        e = torch.where(z <= 0, 1e6, (x - keypoints).norm(dim=-1)).mean(-1)
        errors.append(torch.where(torch.isfinite(e), e, 1e9))
    best = torch.stack(errors, -1).argmin(-1)
    Rs = torch.stack([R for R, _ in candidates], -3)
    ts = torch.stack([t for _, t in candidates], -2)
    rows = torch.arange(len(best), device=best.device)
    return Rs[rows, best], ts[rows, best]


def reprojection_errors(R, t, points, keypoints):
    x, z = project(R, t, points)
    return torch.where(z <= 0, float("inf"), (x - keypoints).norm(dim=-1))


def gauss_newton(R, t, points, keypoints, weights, steps=15):
    """Weighted Gauss-Newton on exp(w) R, t + v."""
    for _ in range(steps):
        P = points @ R.T + t
        x, y, z = P[:, 0], P[:, 1], P[:, 2] + 1e-16
        r = torch.stack([x / z, y / z], -1) - keypoints          # (n, 2)
        zero = torch.zeros_like(z)
        Jp = torch.stack([torch.stack([1 / z, zero, -x / (z * z)], -1),
                          torch.stack([zero, 1 / z, -y / (z * z)], -1)],
                         -2)                                     # (n, 2, 3)
        dP = torch.cat([-hat(points @ R.T),
                        torch.eye(3, device=R.device).expand(len(P), 3, 3)],
                       -1)                                       # (n, 3, 6)
        J = Jp @ dP                                              # (n, 2, 6)
        Jw = J * weights[:, None, None]
        H = (Jw.transpose(-1, -2) @ J).sum(0) + 1e-9 * torch.eye(
            6, device=R.device)
        g = (Jw.transpose(-1, -2) @ r[..., None]).sum(0)[:, 0]
        delta = -torch.linalg.solve(H, g)
        R = rodrigues(delta[:3]) @ R
        t = t + delta[3:]
    return R, t


def trial_counts(Rs, ts, points, keypoints, threshold):
    """Each hypothesis's inliers: the points within ``threshold``."""
    return (reprojection_errors(Rs, ts, points[None], keypoints[None])
            < threshold).sum(-1)
