"""Per-pixel epipolar geometry helpers (counterpart of the helpers in
``tadataka_tpu/vo/semi_dense/estimator.py``).

Only what the plane sweep needs is ported: ``safe_invert``,
``pixel_geometry_map`` (whole-map per-pixel geometry and failure flags
for one refframe), ``calc_key_epipole`` and ``_photo_var``.  The
scattered per-pixel estimator ``update_depth`` is the next slice
(ROADMAP Queue 1).
"""

from typing import NamedTuple

import torch

from tadataka_torch.core.rounding import as_divisor, matmul_small, sqrt
from tadataka_torch.core.transforms import (
    get_rotation, get_translation, inv_motion_matrix)
from tadataka_torch.vo.semi_dense.hypothesis import clamped_range
from tadataka_torch.vo.semi_dense.params import N_KEY_SAMPLES

EPSILON = 1e-16


def safe_invert(v):
    return 1.0 / (v + EPSILON)


def _photo_var(gradient):
    return 2.0 / (gradient + EPSILON)


def _in_image_xy(x, y, image_shape):
    H, W = image_shape
    return (0.0 <= x) & (x <= W - 1.0) & (0.0 <= y) & (y <= H - 1.0)


class PixelGeoScalars(NamedTuple):
    """Per-pixel epipolar geometry, one (N,) tensor per field."""
    x_key_x: torch.Tensor      # normalized key coord
    x_key_y: torch.Tensor
    x_min_ref_x: torch.Tensor  # epipolar segment start (normalized, ref)
    x_min_ref_y: torch.Tensor
    ref_dir_x: torch.Tensor    # unit epipolar direction (ref)
    ref_dir_y: torch.Tensor
    key_dir_x: torch.Tensor    # unit epipolar direction (key)
    key_dir_y: torch.Tensor
    step: torch.Tensor         # ref sampling step (normalized units)
    key_step_size: torch.Tensor
    n_samples: torch.Tensor    # int32
    min_depth: torch.Tensor
    max_depth: torch.Tensor
    flag_neg_ref: torch.Tensor
    flag_key_oob: torch.Tensor
    flag_too_short: torch.Tensor
    flag_close_oob: torch.Tensor
    flag_far_oob: torch.Tensor


def pixel_geometry_map(us_x, us_y, prior_inv_depth, prior_variance, T_rk,
                       e_key, key_focal, key_offset, key_shape,
                       ref_focal, ref_offset, ref_shape, params,
                       n_ref_samples: int):
    """Whole-map per-pixel geometry for ONE refframe (T_rk a single 4x4):
    the epipolar segment of the +-2 sigma prior range, the sampling step,
    the key-side patch direction and step, and the geometric failure
    flags."""
    lo, hi = clamped_range(prior_inv_depth, prior_variance,
                           params.min_inv_depth, params.max_inv_depth)
    min_depth = safe_invert(hi)
    max_depth = safe_invert(lo)

    xk_x = (us_x - key_offset[0]) / key_focal[0]
    xk_y = (us_y - key_offset[1]) / key_focal[1]

    R = get_rotation(T_rk)
    t = get_translation(T_rk)
    # rows of R applied to the homogeneous key ray (xk_x, xk_y, 1)
    r0 = R[0, 0] * xk_x + R[0, 1] * xk_y + R[0, 2]
    r1 = R[1, 0] * xk_x + R[1, 1] * xk_y + R[1, 2]
    r2 = R[2, 0] * xk_x + R[2, 1] * xk_y + R[2, 2]

    def warp_xy(depth):
        z = depth * r2 + t[2]
        return ((depth * r0 + t[0]) / (z + EPSILON),
                (depth * r1 + t[1]) / (z + EPSILON))

    # step ratio: the key step scales with the inverse-depth ratio
    prior_depth = safe_invert(prior_inv_depth)
    ref_depth = prior_depth * r2 + t[2]
    flag_neg_ref = ref_depth <= 0.0
    ratio = prior_inv_depth / safe_invert(torch.clamp(ref_depth,
                                                      min=EPSILON))

    # epipolar segment endpoints on the ref normalized plane
    xmin_x, xmin_y = warp_xy(min_depth)
    xmax_x, xmax_y = warp_xy(max_depth)
    rdx = xmax_x - xmin_x
    rdy = xmax_y - xmin_y
    norm = sqrt(rdx * rdx + rdy * rdy)
    ref_dir_x = rdx / (norm + EPSILON)
    ref_dir_y = rdy / (norm + EPSILON)

    # static budget: stretch the step to cover the range in n_ref_samples
    step = torch.maximum(params.ref_step_size,
                         norm / as_divisor(n_ref_samples - 1, norm))
    n_samples = torch.floor(norm / step).to(torch.int32)

    key_step_size = ratio * step
    dk_x = xk_x - e_key[0]
    dk_y = xk_y - e_key[1]
    aligned = rdx * dk_x + rdy * dk_y > 0.0
    dkn = sqrt(dk_x * dk_x + dk_y * dk_y)
    dkz = dkn == 0.0
    sign = torch.where(aligned, 1.0, -1.0)
    dkn_safe = torch.where(dkz, 1.0, dkn)
    key_dir_x = sign * torch.where(dkz, dk_x, dk_x / dkn_safe)
    key_dir_y = sign * torch.where(dkz, dk_y, dk_y / dkn_safe)

    # key patch in-range test via its two endpoints (+-2 steps)
    half = float(N_KEY_SAMPLES // 2)
    e0x = (xk_x - half * key_step_size * key_dir_x) * key_focal[0] \
        + key_offset[0]
    e0y = (xk_y - half * key_step_size * key_dir_y) * key_focal[1] \
        + key_offset[1]
    e1x = (xk_x + half * key_step_size * key_dir_x) * key_focal[0] \
        + key_offset[0]
    e1y = (xk_y + half * key_step_size * key_dir_y) * key_focal[1] \
        + key_offset[1]
    flag_key_oob = ~(_in_image_xy(e0x, e0y, key_shape)
                     & _in_image_xy(e1x, e1y, key_shape))

    flag_too_short = n_samples < N_KEY_SAMPLES
    un_x = xmin_x * ref_focal[0] + ref_offset[0]
    un_y = xmin_y * ref_focal[1] + ref_offset[1]
    nsf = n_samples.to(us_x.dtype) - 1.0
    uf_x = (xmin_x + nsf * step * ref_dir_x) * ref_focal[0] + ref_offset[0]
    uf_y = (xmin_y + nsf * step * ref_dir_y) * ref_focal[1] + ref_offset[1]
    flag_close_oob = ~_in_image_xy(un_x, un_y, ref_shape)
    flag_far_oob = ~_in_image_xy(uf_x, uf_y, ref_shape)

    return PixelGeoScalars(
        x_key_x=xk_x, x_key_y=xk_y,
        x_min_ref_x=xmin_x, x_min_ref_y=xmin_y,
        ref_dir_x=ref_dir_x, ref_dir_y=ref_dir_y,
        key_dir_x=key_dir_x, key_dir_y=key_dir_y,
        step=step, key_step_size=key_step_size, n_samples=n_samples,
        min_depth=min_depth, max_depth=max_depth,
        flag_neg_ref=flag_neg_ref, flag_key_oob=flag_key_oob,
        flag_too_short=flag_too_short, flag_close_oob=flag_close_oob,
        flag_far_oob=flag_far_oob)


def calc_key_epipole(T_wk, T_wr):
    """Projection of the ref camera centre into the keyframe."""
    R_kw = get_rotation(inv_motion_matrix(T_wk))
    p_key = matmul_small(
        R_kw, (get_translation(T_wr) - get_translation(T_wk))[:, None])[:, 0]
    return p_key[:2] / (p_key[2] + EPSILON)
