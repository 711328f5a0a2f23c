"""Iteratively reweighted least squares with Huber weights (counterpart
of ``tadataka_tpu/robust/irls.py``): MAD scale, Huber weights and a
fixed 30 reweighted normal-equation solves.

Parity and the same bits on the CPU and the card:
- ``jnp.median`` is ``quantile(0.5, method="midpoint")``: (a[lo] +
  a[hi]) * 0.5 of the sorted values, lo = floor((n - 1) / 2), hi =
  ceil((n - 1) / 2).  ``torch.median`` returns the lower middle value,
  so :func:`median` is written out from a sort.
- The normal equations X^T W X and X^T W y sum over all N matches
  pairwise in a fixed order (``rounding.fixed_order_sum``); the 3x3
  system (+1e-10 I) is solved by the fixed-order adjugate inverse
  (``rounding.inv3``) and left-to-right products, on the device with no
  host read.
- Every division by a constant is a true one (``rounding.as_divisor``).
Several right-hand sides y (..., N) share X and are fitted at once.
"""

import torch

from tadataka_torch.core.rounding import (
    as_divisor, fixed_order_sum, inv3, matmul_small)

HUBER_T = 1.345
MAD_SCALE = 0.6745  # statsmodels normalizes MAD by this


def median(x):
    """Median over the last axis as ``jnp.median``: the midpoint of the
    two middle sorted values."""
    s = torch.sort(x, dim=-1).values
    n = x.shape[-1]
    return (s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5


def mad_scale(r):
    """Median absolute deviation from the median, / 0.6745."""
    mad = median(torch.abs(r - median(r)[..., None]))
    return mad / as_divisor(MAD_SCALE, mad)


def huber_weights(z, t=HUBER_T):
    az = torch.abs(z)
    return torch.where(az <= t, torch.ones_like(az),
                       as_divisor(t, az) / torch.clamp(az, min=1e-12))


def _wlstsq(X, y, w):
    """Weighted least squares params (..., d) for X (N, d), y and w (...,
    N), by the normal equations."""
    Xw = X.T * w[..., None, :]                          # (..., d, N)
    d = X.shape[1]
    A = fixed_order_sum(Xw[..., :, None, :] * X.T[None, :, :]) + (
        1e-10 * torch.eye(d, dtype=X.dtype, device=X.device))
    b = fixed_order_sum(Xw * y[..., None, :])
    return matmul_small(inv3(A), b[..., None])[..., 0]


def irls_fit(X, y, max_iter=30):
    """Robust linear regression y ~ X @ params: X (N, 3), y (N,) or
    (..., N) for several fits at once; returns params (3,) or (..., 3)."""
    params = _wlstsq(X, y, torch.ones_like(y))
    for _ in range(max_iter):
        r = y - matmul_small(params[..., None, :], X.T)[..., 0, :]
        scale = mad_scale(r)
        safe = torch.clamp(scale, min=1e-12)
        w = huber_weights(r / safe[..., None])
        w = torch.where((scale <= 0.0)[..., None], torch.ones_like(w), w)
        params = _wlstsq(X, y, w)
    return params
