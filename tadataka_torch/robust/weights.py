"""Robust M-estimator weights for direct VO (counterpart of
``tadataka_tpu/robust/weights.py``): Student-t (nu = 5, ten fixed
variance iterations), Tukey (beta = 4.6851 on MAD-scaled residuals) and
Huber (k = 1.345).

Every function takes an optional validity mask: masked lanes get weight
0 and never enter the statistics.  The CPU and the card give the same
bits: the median is a sort (exact on every device), sums over pixels go
through ``rounding.fixed_order_sum``, divisions by a
Python number through ``rounding.as_divisor`` and roots through
``rounding.sqrt``.  Nothing here syncs with the host.
"""

import torch

from tadataka_torch.core.rounding import as_divisor, fixed_order_sum, sqrt


def _all(x):
    return torch.ones(x.shape, dtype=torch.bool, device=x.device)


def _masked_median(x, mask):
    """Median over the lanes where mask is True: the masked lanes sort to
    +inf, and the median is the mean of the two middle valid values (the
    middle one when their count is odd), as the JAX package takes it."""
    n_valid = mask.sum()
    vals = torch.sort(torch.where(mask, x, float("inf"))).values
    last = x.shape[0] - 1
    hi = torch.clamp(n_valid // 2, 0, last)
    lo = torch.clamp((n_valid - 1) // 2, 0, last)
    # gathered: indexing by a 0-d tensor reads the index on the host
    v_lo, v_hi = torch.gather(vals, 0, torch.stack([lo, hi]))
    return 0.5 * (v_lo + v_hi)


def median_absolute_deviation(x, mask=None):
    if mask is None:
        mask = _all(x)
    med = _masked_median(x, mask)
    return _masked_median(torch.abs(x - med), mask)


def compute_weights_student_t(r, nu=5, n_iter=10, mask=None):
    if mask is None:
        mask = _all(r)
    s = r * r
    n_valid = torch.clamp(mask.sum(), min=1).to(r.dtype)
    numerator = as_divisor(nu + 1, r)

    def weights(variance):
        return numerator / (nu + s / variance)

    variance = torch.ones((), dtype=r.dtype, device=r.device)
    for _ in range(n_iter):
        w = weights(variance)
        variance = fixed_order_sum(
            torch.where(mask, s * w, 0.0)[None])[0] / n_valid
    return torch.where(mask, sqrt(weights(variance)), 0.0)


def tukey(x, beta):
    inside = torch.abs(x) <= beta
    u = x / as_divisor(beta, x)
    v = 1.0 - u * u
    return torch.where(inside, v * v, 0.0)


def compute_weights_tukey(r, beta=4.6851, c=1.4826, mask=None):
    if mask is None:
        mask = _all(r)
    sigma_mad = c * median_absolute_deviation(r, mask)
    w = tukey(r / torch.clamp(sigma_mad, min=1e-12), beta)
    return torch.where(mask, w, 0.0)


def compute_weights_huber(r, k=1.345, mask=None):
    if mask is None:
        mask = _all(r)
    abs_r = torch.abs(r)
    w = torch.where(abs_r > k,
                    as_divisor(k, r) / torch.clamp(abs_r, min=1e-12), 1.0)
    return torch.where(mask, w, 0.0)
