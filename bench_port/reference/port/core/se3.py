"""SE(3) exponential and logarithm (counterpart of
``tadataka_tpu/core/se3.py``).  xi = [v, omega]: translational part
first.  Like ``core/so3.py``, the same bits on the CPU and the card:
the trigonometry from ``core/rounding.py``, 3x3 products summed left to
right, true divisions."""

import torch

from bench_port.reference.port.core.rounding import as_divisor, matmul_small, sincos
from bench_port.reference.port.core.so3 import exp_so3, hat_so3, log_so3, _theta_terms


def _V(rotvec):
    """Left Jacobian V(omega) with Taylor guards, (..., 3) -> (..., 3, 3)."""
    small, sq, safe = (x[..., None, None] for x in _theta_terms(rotvec))
    K = hat_so3(rotvec)
    KK = matmul_small(K, K)
    eye = torch.eye(3, dtype=rotvec.dtype, device=rotvec.device)
    sin_t, cos_t = sincos(safe)
    b = torch.where(small, 0.5 - sq / as_divisor(24.0, sq),
                    (1.0 - cos_t) / (safe * safe))
    c = torch.where(small, 1.0 / 6.0 - sq / as_divisor(120.0, sq),
                    (safe - sin_t) / (safe * safe * safe))
    return eye + b * K + c * KK


def _V_inv(rotvec):
    """Inverse left Jacobian, closed form with a Taylor guard: I - K / 2
    + beta K^2, beta = (1 - t sin t / (2 (1 - cos t))) / t^2."""
    small, sq, safe = (x[..., None, None] for x in _theta_terms(rotvec))
    K = hat_so3(rotvec)
    KK = matmul_small(K, K)
    eye = torch.eye(3, dtype=rotvec.dtype, device=rotvec.device)
    sin_t, cos_t = sincos(safe)
    denom = torch.where(small, torch.ones_like(safe), 2.0 * (1.0 - cos_t))
    beta = torch.where(small, 1.0 / 12.0 + sq / as_divisor(720.0, sq),
                       (1.0 - safe * sin_t / denom) / (safe * safe))
    return eye - 0.5 * K + beta * KK


def exp_se3_t(xi):
    """Translation of exp(xi^): V(omega) @ v, xi (..., 6) -> (..., 3)."""
    return matmul_small(_V(xi[..., 3:]), xi[..., :3, None])[..., 0]


def exp_se3(xi):
    """xi (..., 6) -> 4x4 motion matrix (..., 4, 4)."""
    return _assemble(exp_so3(xi[..., 3:]), exp_se3_t(xi))


def log_se3(G):
    """4x4 motion matrix (..., 4, 4) -> xi (..., 6) = [v, omega]."""
    rotvec = log_so3(G[..., :3, :3])
    v = matmul_small(_V_inv(rotvec), G[..., :3, 3, None])[..., 0]
    return torch.cat([v, rotvec], dim=-1)


def _assemble(R, t):
    G = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    G[..., :3, :3] = R
    G[..., :3, 3] = t
    G[..., 3, 3] = 1.0
    return G
