"""The planner's host checks of a stereo rectification (counterpart of
``tadataka_tpu/vo/semi_dense/rectify.py``, its numpy part).

Fusiello-style rectification rotates both cameras so their x-axes align
with the baseline.  The planner asks, from the 4x4 poses alone, whether
a pair's rectifying homographies stay within the displacement budget;
the rectified sweep itself is not in the reference, since no cell plans
it (``fast.update_depth_fast``).
"""

import numpy as np


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
