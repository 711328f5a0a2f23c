"""Pinhole projection pi and back-projection pi^-1 (counterpart of
``tadataka_tpu/core/projection.py``), with the same z + eps guard."""

import torch

EPSILON = 1e-16


def pi(P):
    """3D point(s) (..., 3) -> normalized image coords (..., 2)."""
    return P[..., :2] / (P[..., 2:3] + EPSILON)


def inv_pi(x, depth):
    """Normalized coords (..., 2) at depth (...,) -> points (..., 3)."""
    return torch.cat([x * depth[..., None], depth[..., None]], dim=-1)
