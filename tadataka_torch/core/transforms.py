"""Rigid transforms and 4x4 motion matrices (counterpart of
``tadataka_tpu/core/transforms.py``).  Natively batched over leading dims.
Matrix products go through ``matmul_small`` (see ``core/rounding.py``)."""

import torch

from tadataka_torch.core.rounding import matmul_small
from tadataka_torch.utils.timing import sync_point


def to_homogeneous(X):
    """(..., d) -> (..., d+1), appending ones."""
    return torch.cat([X, torch.ones(X.shape[:-1] + (1,), dtype=X.dtype,
                                    device=X.device)], dim=-1)


def from_homogeneous(X):
    """(..., d+1) -> (..., d), dropping the last component (no division)."""
    return X[..., :-1]


def motion_matrix(R, t):
    """R (..., 3, 3), t (..., 3) -> T (..., 4, 4)."""
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    with sync_point("sync.transforms.motion_matrix"):
        T[..., 3, 3] = 1.0    # the host scalar's copy to a card can block
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


def relative_transform(T_wa, T_wb):
    """T_ab such that p_a = T_ab @ p_b, from world poses of frames a and b."""
    return inv_motion_matrix(T_wa) @ T_wb


def transform_points(T, P):
    """Apply one 4x4 transform to points (..., 3)."""
    return (matmul_small(P, get_rotation(T).transpose(-1, -2))
            + get_translation(T))


def rotate_each(rotations, points):
    """Per-point rotations: rotations (N, 3, 3), points (N, 3) -> (N, 3)."""
    return torch.einsum('nij,nj->ni', rotations, points)


def transform_each(rotations, translations, points):
    """Apply the i-th (R, t) to the i-th point (all shapes leading N)."""
    return rotate_each(rotations, points) + translations


def transform_all(rotations, translations, points):
    """All pairs: (M poses) x (N points) -> (M, N, 3)."""
    return (torch.einsum('mij,nj->mni', rotations, points)
            + translations[:, None, :])


def inv_transform_all(rotations, translations, points):
    """All pairs of the inverse transform R^T (p - t) -> (M, N, 3)."""
    diff = points[None, :, :] - translations[:, None, :]
    return torch.einsum('mji,mnj->mni', rotations, diff)
