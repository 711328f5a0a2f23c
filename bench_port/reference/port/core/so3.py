"""SO(3): hat map, exponential and logarithm (counterpart of
``tadataka_tpu/core/so3.py``): closed-form Rodrigues with the same
small-angle Taylor branches, and the branch-free quaternion logarithm.

Both maps give the same bits on the CPU and the card: sin, cos, atan2
and the roots come from ``core/rounding.py``, the 3x3 products and the
norms sum left to right, and every division is a true one.  The
exponential stays differentiable under ``torch.func.jacfwd``.
"""

import torch

from bench_port.reference.port.core.rounding import (
    as_divisor, atan2, matmul_small, norm, sincos, sqrt, sqrt_positive,
    sum_small)

# Taylor switchover, as in the JAX package
_SMALL = 1e-5


def hat_so3(v):
    """Skew-symmetric matrix [v]_x of omega (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def _theta_terms(rotvec):
    """(small, sq, safe_theta): theta^2, and theta clamped away from 0
    for the trigonometric branches."""
    sq = sum_small(rotvec * rotvec)
    small = sq < _SMALL * _SMALL
    safe_theta = sqrt_positive(torch.where(small, torch.ones_like(sq), sq))
    return small, sq, safe_theta


def exp_so3(rotvec):
    """Rodrigues: exp([omega]_x) for rotvec (..., 3) -> (..., 3, 3)."""
    small, sq, safe = (x[..., None, None] for x in _theta_terms(rotvec))
    K = hat_so3(rotvec)
    KK = matmul_small(K, K)
    eye = torch.eye(3, dtype=rotvec.dtype, device=rotvec.device)
    sin_t, cos_t = sincos(safe)
    a = torch.where(small, 1.0 - sq / as_divisor(6.0, sq), sin_t / safe)
    b = torch.where(small, 0.5 - sq / as_divisor(24.0, sq),
                    (1.0 - cos_t) / (safe * safe))
    return eye + a * K + b * KK


def exp_so3_small(rotvec):
    """exp_so3's small-angle branch, I + (1 - theta^2 / 6) K + (1/2 -
    theta^2 / 24) K^2: the value and the derivatives exp_so3 gives where
    theta < 1e-5 (as at rotvec = 0, where a Gauss-Newton step
    differentiates it), without evaluating the trigonometric branch."""
    sq = sum_small(rotvec * rotvec)[..., None, None]
    K = hat_so3(rotvec)
    eye = torch.eye(3, dtype=rotvec.dtype, device=rotvec.device)
    a = 1.0 - sq / as_divisor(6.0, sq)
    b = 0.5 - sq / as_divisor(24.0, sq)
    return eye + a * K + b * matmul_small(K, K)


def log_so3(R):
    """Rotation matrix (..., 3, 3) -> rotvec (..., 3), via the quaternion."""
    return _rotvec_from_quat(_quat_from_matrix(R))


def _quat_from_matrix(R):
    """Rotation matrix -> unit quaternion (w, x, y, z), Shepperd's method
    with the best-conditioned candidate chosen branch-free."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    def safe_sqrt(x):
        return sqrt(torch.clamp(x, min=1e-24))

    sw = safe_sqrt(qw2) * 2.0
    cand_w = torch.stack([sw / 4.0, (m21 - m12) / sw, (m02 - m20) / sw,
                          (m10 - m01) / sw], dim=-1)
    sx = safe_sqrt(qx2) * 2.0
    cand_x = torch.stack([(m21 - m12) / sx, sx / 4.0, (m01 + m10) / sx,
                          (m02 + m20) / sx], dim=-1)
    sy = safe_sqrt(qy2) * 2.0
    cand_y = torch.stack([(m02 - m20) / sy, (m01 + m10) / sy, sy / 4.0,
                          (m12 + m21) / sy], dim=-1)
    sz = safe_sqrt(qz2) * 2.0
    cand_z = torch.stack([(m10 - m01) / sz, (m02 + m20) / sz,
                          (m12 + m21) / sz, sz / 4.0], dim=-1)
    best = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], dim=-1),
                        dim=-1)[..., None]
    q = torch.where(best == 0, cand_w,
                    torch.where(best == 1, cand_x,
                                torch.where(best == 2, cand_y, cand_z)))
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    return q / norm(q)[..., None]


def _rotvec_from_quat(q):
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    xyz = q[..., 1:]
    s = norm(xyz)
    theta = 2.0 * atan2(s, w)
    scale = torch.where(s < _SMALL,
                        2.0 + theta * theta / as_divisor(12.0, theta),
                        theta / torch.clamp(s, min=1e-24))
    return xyz * scale[..., None]


def is_rotation_matrix(R, atol=1e-5):
    """Whether R (..., 3, 3) is orthonormal with determinant 1 within
    ``atol``, as one bool for the whole batch (``jnp.allclose``'s
    |a - b| <= atol + 1e-5 |b|)."""
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    one = torch.ones((), dtype=R.dtype, device=R.device)
    orth = torch.allclose(R @ R.transpose(-1, -2), eye.expand(R.shape),
                          rtol=1e-5, atol=atol)
    det = torch.allclose(torch.linalg.det(R), one.expand(R.shape[:-2]),
                         rtol=1e-5, atol=atol)
    return orth and det
