"""Rigid transforms and 4x4 motion matrices (counterpart of
``tadataka_tpu/core/transforms.py``).  Natively batched over leading dims.
Matrix products go through ``matmul_small`` (see ``core/rounding.py``)."""

import torch

from tadataka_torch.core.rounding import matmul_small


def motion_matrix(R, t):
    """R (..., 3, 3), t (..., 3) -> T (..., 4, 4)."""
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def get_rotation(T):
    return T[..., :3, :3]


def get_translation(T):
    return T[..., :3, 3]


def inv_motion_matrix(T):
    """Closed-form SE(3) inverse: [R^T, -R^T t]."""
    Rt = get_rotation(T).transpose(-1, -2)
    return motion_matrix(
        Rt, -matmul_small(Rt, get_translation(T)[..., None])[..., 0])


def transform_points(T, P):
    """Apply one 4x4 transform to points (..., 3)."""
    return (matmul_small(P, get_rotation(T).transpose(-1, -2))
            + get_translation(T))
