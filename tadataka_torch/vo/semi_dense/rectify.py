"""Stereo rectification of a (key, ref) pair (counterpart of
``tadataka_tpu/vo/semi_dense/rectify.py``).

Fusiello-style rectification rotates both cameras so their x-axes align
with the baseline.  In the rectified pair every epipolar line is a
scanline and the match of key pixel x at inverse depth q sits at
x - fB v_z(x) q, so the rectified sweep (``sweep_rect.py``) searches
constant column shifts.  ``make_rectification`` builds the homographies
on the device; the host checks below let the planner ask whether a
pair's homographies stay within the displacement budget.
"""

from typing import NamedTuple

import numpy as np
import torch

from tadataka_torch.core.rounding import inv3, matmul_small, cross3, norm3

EPSILON = 1e-16


class Rectification(NamedTuple):
    """Device-side rectification of one pair.

    H_key / H_ref map original key / ref pixels to UNFLIPPED rectified
    pixels; the inverses map back.  Disparity at inverse key depth q is
    d(x, q) = fB * v_z(x) * q with v_z(x) = r1_z x~ + r2_z y~ + r3_z on
    the rectified normalized grid; ``vz`` holds (r1_z, r2_z, r3_z) and
    ``fB`` is the key's x focal length times the baseline.
    """
    H_key: torch.Tensor
    H_ref: torch.Tensor
    H_key_inv: torch.Tensor
    H_ref_inv: torch.Tensor
    fB: torch.Tensor
    vz: torch.Tensor


def _intrinsics(focal, offset):
    zero = torch.zeros_like(focal[0])
    one = torch.ones_like(focal[0])
    return torch.stack([torch.stack([focal[0], zero, offset[0]]),
                        torch.stack([zero, focal[1], offset[1]]),
                        torch.stack([zero, zero, one])])


def _intrinsics_inv(focal, offset):
    zero = torch.zeros_like(focal[0])
    one = torch.ones_like(focal[0])
    return torch.stack([
        torch.stack([1.0 / focal[0], zero, -offset[0] / focal[0]]),
        torch.stack([zero, 1.0 / focal[1], -offset[1] / focal[1]]),
        torch.stack([zero, zero, one])])


def make_rectification(T_rk, key_focal, key_offset, ref_focal, ref_offset,
                       flip: bool) -> Rectification:
    """The rectifying homographies of one pair, on T_rk's device.

    T_rk: 4x4, P_ref = R P_key + t.  ``flip`` (from :func:`baseline_flip`)
    picks the baseline's sign so that the rotation stays small; the
    caller x-flips the rectified images to keep disparity = +fB q.
    """
    R_rk = T_rk[:3, :3]
    t_rk = T_rk[:3, 3]
    b = -matmul_small(R_rk.T, t_rk[:, None])[:, 0]   # ref centre, key frame
    B = norm3(b) + EPSILON
    r1 = (-1.0 if flip else 1.0) * b / B
    z = torch.zeros_like(r1)
    z[2] = 1.0
    r2 = cross3(z, r1)
    r2 = r2 / (norm3(r2) + EPSILON)
    r3 = cross3(r1, r2)
    R_new = torch.stack([r1, r2, r3])          # key-frame coords -> rect

    K_rect = _intrinsics(key_focal, key_offset)
    H_key = matmul_small(matmul_small(K_rect, R_new),
                         _intrinsics_inv(key_focal, key_offset))
    H_ref = matmul_small(matmul_small(matmul_small(K_rect, R_new), R_rk.T),
                         _intrinsics_inv(ref_focal, ref_offset))
    return Rectification(H_key=H_key, H_ref=H_ref, H_key_inv=inv3(H_key),
                         H_ref_inv=inv3(H_ref), fB=key_focal[0] * B,
                         vz=torch.stack([r1[2], r2[2], r3[2]]))


def baseline_flip(T_rk_np) -> bool:
    """True when the baseline points toward -x."""
    R = np.asarray(T_rk_np)[:3, :3]
    t = np.asarray(T_rk_np)[:3, 3]
    return bool((-R.T @ t)[0] < 0.0)


def _np_homography_displacement(H33, image_shape, n=9):
    """Max |H x - x| over a coarse grid, per axis."""
    H33 = np.asarray(H33, np.float64)
    Hh, Ww = image_shape
    X, Y = np.meshgrid(np.linspace(0, Ww - 1.0, n), np.linspace(0, Hh - 1.0, n))
    Q = H33 @ np.stack([X.ravel(), Y.ravel(), np.ones(X.size)])
    w = Q[2]
    if np.any(w <= 1e-9):
        return np.inf, np.inf
    return (float(np.abs(Q[0] / w - X.ravel()).max()),
            float(np.abs(Q[1] / w - Y.ravel()).max()))


def _K(f, c):
    return np.array([[f[0], 0, c[0]], [0, f[1], c[1]], [0, 0, 1.0]])


def rectification_feasible(T_rk_np, key_focal, key_offset, ref_focal,
                           ref_offset, image_shape, max_dx, max_dy):
    """Does this pair's rectification fit the displacement budget?
    Checks both homographies and their inverses on a coarse grid.
    Returns (feasible, flip)."""
    T = np.asarray(T_rk_np, np.float64)
    flip = baseline_flip(T)
    R_rk, t_rk = T[:3, :3], T[:3, 3]
    b = -R_rk.T @ t_rk
    B = np.linalg.norm(b)
    if B < 1e-12:
        return False, flip
    r1 = (-1.0 if flip else 1.0) * b / B
    r2 = np.cross([0.0, 0.0, 1.0], r1)
    n2 = np.linalg.norm(r2)
    if n2 < 1e-6:                    # baseline parallel to the optical axis
        return False, flip
    r2 = r2 / n2
    R_new = np.stack([r1, r2, np.cross(r1, r2)])
    K_key = _K(np.asarray(key_focal), np.asarray(key_offset))
    H_key = K_key @ R_new @ np.linalg.inv(K_key)
    H_ref = K_key @ R_new @ R_rk.T @ np.linalg.inv(
        _K(np.asarray(ref_focal), np.asarray(ref_offset)))
    for H in (H_key, H_ref, np.linalg.inv(H_key), np.linalg.inv(H_ref)):
        dx, dy = _np_homography_displacement(H, image_shape)
        if dx > max_dx or dy > max_dy:
            return False, flip
    return True, flip
