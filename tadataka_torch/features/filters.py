"""Match validation: a homography DLT and the chi-squared symmetric
transfer test (counterpart of ``tadataka_tpu/features/filters.py``).
Batched over leading dims: (..., K, 2) point sets with (..., K) masks."""

import numpy as np
import torch

from tadataka_torch.core.rounding import as_divisor
from tadataka_torch.core.solvers import inv, solve_nullspace, svd
from tadataka_torch.core.transforms import to_homogeneous

# chi2.ppf(0.95, dof=2)
CHI2_95_DOF2 = 5.991464547107979
EPSILON = 1e-10
SQRT2 = float(np.sqrt(np.float32(2.0)))   # the float32 root, as jnp.sqrt


def hartley_matrix(scale, mean):
    """[[s, 0, -s mx], [0, s, -s my], [0, 0, 1]] for scale (...,) and mean
    (..., 2)."""
    z = torch.zeros_like(scale)
    return torch.stack([
        torch.stack([scale, z, -scale * mean[..., 0]], dim=-1),
        torch.stack([z, scale, -scale * mean[..., 1]], dim=-1),
        torch.stack([z, z, torch.ones_like(scale)], dim=-1)], dim=-2)


def _masked_normalization(points, mask):
    """Hartley normalization of the masked point set: (centered * scale,
    T)."""
    w = mask.to(points.dtype)
    n = torch.clamp(torch.sum(w, dim=-1), min=1.0)
    mean = torch.sum(points * w[..., None], dim=-2) / n[..., None]
    centered = points - mean[..., None, :]
    dist = torch.linalg.vector_norm(centered, dim=-1) * w
    scale = as_divisor(SQRT2, dist) / (torch.sum(dist, dim=-1) / n + EPSILON)
    return centered * scale[..., None, None], hartley_matrix(scale, mean)


def estimate_homography(kp1, kp2, mask):
    """Masked, Hartley-normalized DLT homography (invalid rows zeroed)."""
    w = mask.to(kp1.dtype)[..., None]
    p1, T1 = _masked_normalization(kp1, mask)
    p2, T2 = _masked_normalization(kp2, mask)
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    zero = torch.zeros_like(x1)
    one = torch.ones_like(x1)
    rows_a = torch.stack([x1, y1, one, zero, zero, zero,
                          -x2 * x1, -x2 * y1, -x2], dim=-1)
    rows_b = torch.stack([zero, zero, zero, x1, y1, one,
                          -y2 * x1, -y2 * y1, -y2], dim=-1)
    h = solve_nullspace(torch.cat([rows_a * w, rows_b * w], dim=-2))
    H = inv(T2) @ h.reshape(h.shape[:-1] + (3, 3)) @ T1
    return H / (H[..., 2:3, 2:3] + EPSILON)


def _apply_homography(H, points):
    p = to_homogeneous(points) @ H.transpose(-1, -2)
    return p[..., :2] / (p[..., 2:3] + EPSILON)


def _zca_whiten(X, mask):
    """Masked mean-centering and ZCA whitening of 2-D residuals."""
    w = mask.to(X.dtype)[..., None]
    n = torch.clamp(torch.sum(w, dim=-2), min=1.0)        # (..., 1)
    mean = torch.sum(X * w, dim=-2) / n
    Xc = (X - mean[..., None, :]) * w
    C = (Xc.transpose(-1, -2) @ Xc) / torch.clamp(n - 1.0, min=1.0)[..., None]
    U, s, _ = svd(C)
    S = 1.0 / (torch.sqrt(s) + EPSILON)
    ZCA = (U * S[..., None, :]) @ U.transpose(-1, -2)
    return (X - mean[..., None, :]) @ ZCA.transpose(-1, -2)


def chi_squared_test(X, mask, threshold=CHI2_95_DOF2):
    Y = _zca_whiten(X, mask)
    return torch.sum(Y * Y, dim=-1) <= threshold


def symmetric_transfer_filter(kp1, kp2, mask, p=0.95):
    """Inlier mask from the symmetric transfer error under a fitted
    homography (the threshold is chi2's at p = 0.95, 2 dof)."""
    del p
    H = estimate_homography(kp1, kp2, mask)
    D12 = _apply_homography(H, kp1) - kp2
    D21 = kp1 - _apply_homography(inv(H), kp2)
    return chi_squared_test(D12, mask) & chi_squared_test(D21, mask) & mask
