"""Per-pixel epipolar inverse-depth estimation (counterpart of
``tadataka_tpu/vo/semi_dense/estimator.py``).

``update_depth`` is the scattered estimator, the reference semantics
that the planner falls back to: for every pixel, ``n_ref_samples``
bilinear samples along its epipolar segment in its refframe, a
normalized-SSD match of the five-sample key patch, triangulation, the
variance model and the failure flags.  It is plain PyTorch on (S, N)
sample tensors (N pixels): on the card its per-pixel gathers are cheap.
The helpers (``pixel_geometry_map``, ``calc_key_epipole``, ...) are
shared with the plane sweeps.  ``estimate_pixel`` runs the same pieces
on one pixel, and ``estimate_debug`` is the one-pixel entry that drives
each failure flag.
"""

from typing import NamedTuple

import torch

from bench_port.reference.port.flags import Flag
from bench_port.reference.port.core.gradients import sobel_x, sobel_y
from bench_port.reference.port.core.rounding import as_divisor, matmul_small, sqrt
from bench_port.reference.port.core.transforms import (
    get_rotation, get_translation, inv_motion_matrix)
from bench_port.reference.port.vo.semi_dense.fusion import fusion
from bench_port.reference.port.vo.semi_dense.hypothesis import (
    check_args_flag, clamped_range)
from bench_port.reference.port.vo.semi_dense.params import (
    N_KEY_SAMPLES, DEFAULT_N_REF_SAMPLES)

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


# ------------------------------------------------------ scattered update

def _key_coords(geo, steps, key_focal, key_offset):
    """Key-patch sample pixel coords; ``steps`` (5, 1) carries the sample
    axis against the (N,) fields -> (5, N)."""
    us_key_x = ((geo.x_key_x + steps * (geo.key_step_size * geo.key_dir_x))
                * key_focal[0] + key_offset[0])
    us_key_y = ((geo.x_key_y + steps * (geo.key_step_size * geo.key_dir_y))
                * key_focal[1] + key_offset[1])
    return us_key_x, us_key_y


def _ref_coords(geo, idx, ref_focal_x, ref_focal_y, ref_offset_x,
                ref_offset_y):
    """Ref epipolar sample pixel coords; ``idx`` (S, 1) carries the
    sample axis -> (S, N)."""
    us_ref_x = ((geo.x_min_ref_x + idx * (geo.step * geo.ref_dir_x))
                * ref_focal_x + ref_offset_x)
    us_ref_y = ((geo.x_min_ref_y + idx * (geo.step * geo.ref_dir_y))
                * ref_focal_y + ref_offset_y)
    return us_ref_x, us_ref_y


def _corner_index(v, n):
    """floor(v) as an index clipped to [0, n-1], and its fraction.  The
    float is clamped before the cast, so a far-off coordinate saturates
    as XLA's conversion does."""
    lv = torch.floor(v)
    i0 = torch.clamp(torch.nan_to_num(torch.clamp(lv, -1.0, float(n))),
                     0, n - 1).to(torch.int64)
    return i0, torch.clamp(i0 + 1, max=n - 1), v - lv


def _interp_stack_xy(images, r, x, y):
    """Bilinear sample of a (R, H, W) stack; ``r`` broadcasts against
    x / y.  The four taps are clipped to the image."""
    R, H, W = images.shape
    flat = images.reshape(-1)
    x0, x1, ax = _corner_index(x, W)
    y0, y1, ay = _corner_index(y, H)
    base = r.to(torch.int64) * (H * W)
    b0 = base + y0 * W
    b1 = base + y1 * W
    v00 = flat[b0 + x0]
    v01 = flat[b0 + x1]
    v10 = flat[b1 + x0]
    v11 = flat[b1 + x1]
    return ((1 - ax) * (1 - ay) * v00 + ax * (1 - ay) * v01
            + (1 - ax) * ay * v10 + ax * ay * v11)


def _interp_image_xy(image, x, y):
    """Bilinear sample of one (H, W) image at x / y arrays."""
    return _interp_stack_xy(image[None], torch.zeros((), dtype=torch.int64,
                                                     device=image.device),
                            x, y)


def _normalize_xy(x, y):
    """(x, y) / |(x, y)|, unchanged where the norm is 0."""
    n = sqrt(x * x + y * y)
    z = n == 0.0
    n = torch.where(z, 1.0, n)
    return torch.where(z, x, x / n), torch.where(z, y, y / n)


def _ssd_search(ref_intensities, key_intensities, n_valid):
    """Masked normalized-SSD template match along each pixel's line.

    ref_intensities (S, N), key_intensities (5, N), n_valid (N,) the
    count of valid ref samples.  Returns the matched sample index
    (argmin + 2), the earliest window on a tie.  Norms and sums run left
    to right, the roots correctly rounded, so an ulp cannot move a tie
    between devices."""
    S = ref_intensities.shape[0]
    M = S - N_KEY_SAMPLES + 1
    w = [ref_intensities[k:k + M] for k in range(N_KEY_SAMPLES)]
    kk = key_intensities
    wn2 = w[0] * w[0]
    kn2 = kk[0] * kk[0]
    for k in range(1, N_KEY_SAMPLES):
        wn2 = wn2 + w[k] * w[k]
        kn2 = kn2 + kk[k] * kk[k]
    wnorm = sqrt(wn2) + EPSILON
    knorm = sqrt(kn2) + EPSILON
    d = w[0] / wnorm - kk[0] / knorm
    errors = d * d
    for k in range(1, N_KEY_SAMPLES):
        d = w[k] / wnorm - kk[k] / knorm
        errors = errors + d * d
    idx = torch.arange(M, device=errors.device)[:, None]
    errors = torch.where(idx <= n_valid - N_KEY_SAMPLES, errors, torch.inf)
    return torch.argmin(errors, dim=0) + N_KEY_SAMPLES // 2


def _warp_point_xy(R, t, x, y, depth):
    """x / y of the normalized key point (x, y) at ``depth`` through
    (R, t), per pixel: the JAX package's ``_warp_point``."""
    px, py = x * depth, y * depth
    P = [R[i][0] * px + R[i][1] * py + R[i][2] * depth + t[i]
         for i in range(3)]
    return P[0] / (P[2] + EPSILON), P[1] / (P[2] + EPSILON)


def _pixel_estimate(geo, key_int, ref_int, grad_x, grad_y, prior_inv,
                    prior_var, R, t, params):
    """Every pixel's estimate from its sampled intensities.

    ``R`` / ``t``: per-pixel rotation rows R[i][j] and translation t[i],
    each (N,).  Returns (inv_depth, variance, flag) before the prior
    checks; a pixel that fails keeps its prior."""
    f32 = key_int.dtype
    dg = key_int[1:] - key_int[:-1]
    key_gradient = sqrt(dg[0] * dg[0] + dg[1] * dg[1] + dg[2] * dg[2]
                        + dg[3] * dg[3])
    flag_insufficient = key_gradient < params.min_gradient

    match = _ssd_search(ref_int, key_int, geo.n_samples).to(f32)
    xr_x = geo.x_min_ref_x + match * geo.step * geo.ref_dir_x
    xr_y = geo.x_min_ref_y + match * geo.step * geo.ref_dir_y

    # triangulate along the axis of the larger |t| component
    xk_x, xk_y = geo.x_key_x, geo.x_key_y
    ry = [R[i][0] * xk_x + R[i][1] * xk_y + R[i][2] for i in range(3)]

    def depth_along(i, x1):
        n = t[i] - t[2] * x1
        d = ry[2] * x1 - ry[i]
        return n / (d + EPSILON)

    key_depth = torch.where(torch.abs(t[0]) > torch.abs(t[1]),
                            depth_along(0, xr_x), depth_along(1, xr_y))
    new_inv_depth = safe_invert(key_depth)

    # d(inverse depth)/d(epipolar position)
    xmin_x, xmin_y = _warp_point_xy(R, t, xk_x, xk_y, geo.min_depth)
    xmax_x, xmax_y = _warp_point_xy(R, t, xk_x, xk_y, geo.max_depth)
    dir_x, dir_y = _normalize_xy(xmax_x - xmin_x, xmax_y - xmin_y)
    xp_x, xp_y = _warp_point_xy(R, t, xk_x, xk_y, key_depth)

    def alpha_along(i, direction, x_ref):
        d = ry[2] * t[i] - ry[i] * t[2]
        n = x_ref * t[2] - t[i]
        return direction * d / (n * n + EPSILON)

    alpha = torch.where(torch.abs(dir_x) > torch.abs(dir_y),
                        alpha_along(0, dir_x, xp_x),
                        alpha_along(1, dir_y, xp_y))

    # geometric variance 1 / <epipolar direction, gradient>^2
    ex, ey = _normalize_xy(xk_x - t[0] / (t[2] + EPSILON),
                           xk_y - t[1] / (t[2] + EPSILON))
    gxn, gyn = _normalize_xy(grad_x, grad_y)
    p = ex * gxn + ey * gyn
    geo_v = torch.where(p == 0.0, 1.0 / EPSILON, 1.0 / (p * p + EPSILON))
    photo = _photo_var(key_gradient / (geo.key_step_size + EPSILON))
    variance = alpha * alpha * (params.geo_coeff ** 2 * geo_v
                                + params.photo_coeff ** 2 * photo)

    # priority chain, the earliest failure of the reference wins
    flag = check_args_flag(new_inv_depth, variance, params.min_inv_depth,
                           params.max_inv_depth)
    for cond, value in ((geo.flag_far_oob, Flag.REF_FAR_OUT_OF_RANGE),
                        (geo.flag_close_oob, Flag.REF_CLOSE_OUT_OF_RANGE),
                        (geo.flag_too_short, Flag.REF_EPIPOLAR_TOO_SHORT),
                        (flag_insufficient, Flag.INSUFFICIENT_GRADIENT),
                        (geo.flag_key_oob, Flag.KEY_OUT_OF_RANGE),
                        (geo.flag_neg_ref, Flag.NEGATIVE_REF_DEPTH)):
        flag = torch.where(cond, int(value), flag)
    success = flag == int(Flag.SUCCESS)
    return (torch.where(success, new_inv_depth, prior_inv),
            torch.where(success, variance, prior_var), flag)


def _gradient_at(grad_map, us_x, us_y):
    """``grad_map`` at the pixel of each (x, y), truncated and clipped to
    the image."""
    H, W = grad_map.shape
    ux = torch.clamp(us_x.to(torch.int64), 0, W - 1)
    uy = torch.clamp(us_y.to(torch.int64), 0, H - 1)
    return grad_map.reshape(-1)[uy * W + ux]


def estimate_pixel(u_key, prior_inv_depth, prior_variance, T_rk, e_key,
                   key_focal, key_offset, key_image, ref_focal, ref_offset,
                   ref_images, ref_index, grad_x_map, grad_y_map, params,
                   n_ref_samples):
    """One pixel's inverse-depth update, by the scattered estimator's
    pieces on a map of one pixel.  Returns 0-d (inv_depth, variance,
    flag) before the prior checks.

    ``u_key`` (2,) the (x, y) pixel, ``T_rk`` (4, 4), ``e_key`` (2,),
    ``ref_images`` the (R, H, W) stack and ``ref_index`` this pixel's
    frame in it."""
    f32 = u_key.dtype
    device = u_key.device
    us_x, us_y = u_key[0:1], u_key[1:2]
    prior_inv = prior_inv_depth.reshape(1)
    prior_var = prior_variance.reshape(1)
    geo = pixel_geometry_map(
        us_x, us_y, prior_inv, prior_var, T_rk, e_key, key_focal,
        key_offset, tuple(key_image.shape), ref_focal, ref_offset,
        tuple(ref_images.shape[1:]), params, n_ref_samples)
    steps = torch.arange(-(N_KEY_SAMPLES // 2), N_KEY_SAMPLES // 2 + 1,
                         dtype=f32, device=device)[:, None]
    us_key_x, us_key_y = _key_coords(geo, steps, key_focal, key_offset)
    idx = torch.arange(n_ref_samples, dtype=f32, device=device)[:, None]
    us_ref_x, us_ref_y = _ref_coords(geo, idx, ref_focal[0], ref_focal[1],
                                     ref_offset[0], ref_offset[1])
    key_int = _interp_image_xy(key_image, us_key_x, us_key_y)
    ref_int = _interp_stack_xy(
        ref_images, torch.as_tensor(ref_index, device=device), us_ref_x,
        us_ref_y)
    R = [[T_rk[i, j] for j in range(3)] for i in range(3)]
    t = [T_rk[i, 3] for i in range(3)]
    inv_d, var, flag = _pixel_estimate(
        geo, key_int, ref_int, _gradient_at(grad_x_map, us_x, us_y),
        _gradient_at(grad_y_map, us_x, us_y), prior_inv, prior_var, R, t,
        params)
    return inv_d[0], var[0], flag[0]


def estimate_debug(u_key, prior_depth, prior_variance, keyframe, refframe,
                   params, n_ref_samples=DEFAULT_N_REF_SAMPLES):
    """Single-pixel debug entry: (depth, variance, flag) of the (x, y)
    pixel ``u_key`` against one refframe, from a plain prior depth and
    variance.  A prior that fails its checks gives its own flag and is
    returned unchanged, ahead of every estimation flag."""
    f32 = keyframe.image.dtype
    device = keyframe.image.device
    T_wk = keyframe.transform_wf
    T_wr = refframe.transform_wf
    T_rk = matmul_small(inv_motion_matrix(T_wr), T_wk)
    e_key = calc_key_epipole(T_wk, T_wr)
    u = torch.as_tensor(u_key, dtype=f32, device=device)
    prior_inv = safe_invert(torch.as_tensor(prior_depth, dtype=f32,
                                            device=device))
    prior_var = torch.as_tensor(prior_variance, dtype=f32, device=device)
    inv_d, var, flag = estimate_pixel(
        u, prior_inv, prior_var, T_rk, e_key, keyframe.focal_length,
        keyframe.offset, keyframe.image, refframe.focal_length,
        refframe.offset, refframe.image[None], 0, sobel_x(keyframe.image),
        sobel_y(keyframe.image), params, n_ref_samples)
    prior_flag = check_args_flag(prior_inv, prior_var, params.min_inv_depth,
                                 params.max_inv_depth)
    prior_bad = prior_flag != int(Flag.SUCCESS)
    flag = torch.where(prior_bad, prior_flag, flag)
    inv_d = torch.where(prior_bad, prior_inv, inv_d)
    var = torch.where(prior_bad, prior_var, var)
    return safe_invert(inv_d), var, flag


def update_depth(keyframe, refframes, age_map, prior_depth, prior_variance,
                 params, n_ref_samples=DEFAULT_N_REF_SAMPLES, row_offset=0,
                 fuse_prior=False):
    """Full-map inverse-depth update by the scattered estimator.

    keyframe + stacked refframe history (oldest first); each pixel's age
    selects refframe R - age.  Returns (depth_map, variance_map,
    flag_map).  With ``fuse_prior`` a new observation is fused with the
    prior (the LSD-SLAM depth filter) instead of replacing it.

    The prior and age maps may be a block of rows of the image;
    ``row_offset`` (an int or a 0-d tensor) is the block's first row, so
    pixel coordinates stay those of the whole image.  The key and ref
    images are always whole.
    """
    H, W = prior_depth.shape
    R_frames = refframes.image.shape[0]
    f32 = keyframe.image.dtype
    device = keyframe.image.device

    T_wk = keyframe.transform_wf
    T_rk_all = matmul_small(inv_motion_matrix(refframes.transform_wf), T_wk)

    Y, X = torch.meshgrid(torch.arange(H, dtype=f32, device=device),
                          torch.arange(W, dtype=f32, device=device),
                          indexing="ij")
    us_x = X.ravel()
    # a Python offset is added as a scalar: no copy to the device
    us_y = Y.ravel() + (row_offset.to(device=device, dtype=f32)
                        if isinstance(row_offset, torch.Tensor)
                        else float(row_offset))
    age = age_map.ravel().to(torch.int32)
    prior_v = prior_variance.ravel().to(f32)
    prior_inv = safe_invert(prior_depth.ravel().to(f32))
    ridx = torch.clamp(R_frames - age, 0, R_frames - 1).to(torch.int64)

    def select_ref(*per_ref):
        out = per_ref[0]
        for i in range(1, R_frames):
            out = torch.where(ridx == i, per_ref[i], out)
        return out

    # per-pixel geometry and failure flags of each pixel's refframe
    key_shape = tuple(keyframe.image.shape)
    ref_shape = tuple(refframes.image.shape[1:])
    geos = [
        pixel_geometry_map(
            us_x, us_y, prior_inv, prior_v, T_rk_all[r],
            calc_key_epipole(T_wk, refframes.transform_wf[r]),
            keyframe.focal_length, keyframe.offset, key_shape,
            refframes.focal_length[r], refframes.offset[r], ref_shape,
            params, n_ref_samples)
        for r in range(R_frames)]
    geo = type(geos[0])(*(select_ref(*fields) for fields in zip(*geos)))

    # sample coordinates (5, N) / (S, N) and all image gathers at once
    steps = torch.arange(-(N_KEY_SAMPLES // 2), N_KEY_SAMPLES // 2 + 1,
                         dtype=f32, device=device)[:, None]
    us_key_x, us_key_y = _key_coords(geo, steps, keyframe.focal_length,
                                     keyframe.offset)
    rf = refframes.focal_length[ridx].T                      # (2, N)
    ro = refframes.offset[ridx].T
    idx = torch.arange(n_ref_samples, dtype=f32, device=device)[:, None]
    us_ref_x, us_ref_y = _ref_coords(geo, idx, rf[0], rf[1], ro[0], ro[1])
    key_int = _interp_image_xy(keyframe.image, us_key_x, us_key_y)
    ref_int = _interp_stack_xy(refframes.image, ridx[None, :], us_ref_x,
                               us_ref_y)
    del us_ref_x, us_ref_y

    T_pix = T_rk_all[ridx]                                   # (N, 4, 4)
    R = [[T_pix[:, i, j] for j in range(3)] for i in range(3)]
    t = [T_pix[:, i, 3] for i in range(3)]
    inv_d, var, flag = _pixel_estimate(
        geo, key_int, ref_int,
        _gradient_at(sobel_x(keyframe.image), us_x, us_y),
        _gradient_at(sobel_y(keyframe.image), us_x, us_y), prior_inv,
        prior_v, R, t, params)

    prior_flag = check_args_flag(prior_inv, prior_v, params.min_inv_depth,
                                 params.max_inv_depth)
    prior_bad = prior_flag != int(Flag.SUCCESS)
    not_processed = age == 0
    flag = torch.where(prior_bad, prior_flag, flag)
    flag = torch.where(not_processed, int(Flag.NOT_PROCESSED), flag)
    keep_prior = not_processed | prior_bad
    inv_d = torch.where(keep_prior, prior_inv, inv_d)
    var = torch.where(keep_prior, prior_v, var)
    if fuse_prior:
        f_mu, f_var = fusion(inv_d, prior_inv, var, prior_v)
        success = flag == int(Flag.SUCCESS)
        inv_d = torch.where(success, f_mu, inv_d)
        var = torch.where(success, f_var, var)
    return (safe_invert(inv_d).reshape(H, W), var.reshape(H, W),
            flag.reshape(H, W))
