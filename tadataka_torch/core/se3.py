"""SE(3) exponential (counterpart of ``exp_se3_t`` in
``tadataka_tpu/core/se3.py``).  xi = [v, omega]: translational part
first."""

import torch

from tadataka_torch.core.so3 import hat_so3, _theta_terms


def _V(rotvec):
    """Left Jacobian V(omega) with Taylor guards, (..., 3) -> (..., 3, 3)."""
    small, sq, safe = (x[..., None, None] for x in _theta_terms(rotvec))
    K = hat_so3(rotvec)
    KK = K @ K
    eye = torch.eye(3, dtype=rotvec.dtype, device=rotvec.device)
    b = torch.where(small, 0.5 - sq / 24.0,
                    (1.0 - torch.cos(safe)) / (safe * safe))
    c = torch.where(small, 1.0 / 6.0 - sq / 120.0,
                    (safe - torch.sin(safe)) / (safe ** 3))
    return eye + b * K + c * KK


def exp_se3_t(xi):
    """Translation of exp(xi^): V(omega) @ v, xi (..., 6) -> (..., 3)."""
    return (_V(xi[..., 3:]) @ xi[..., :3, None])[..., 0]

