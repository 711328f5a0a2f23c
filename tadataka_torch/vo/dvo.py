"""Direct photometric (RGB-D) visual odometry, inverse-compositional
Gauss-Newton over an image pyramid (counterpart of
``tadataka_tpu/vo/dvo.py``; the forward-compositional method and the
robust weights are ROADMAP work).

Each level's loop stops, like the JAX ``lax.while_loop``, after the
first iteration whose photometric error does not improve (or after
``max_iter + 1`` iterations) and returns the best pose seen.

The CPU and the card give the same bits: every sum over pixels is one
fixed-order pairwise reduction (:func:`fixed_order_sum`), the pyramid
resize sums its few nonzero taps left to right, and the 6x6 float32
solve (``torch.linalg.solve``, TF32 off) with the pose update runs on the
host.  Fetching the normal equations is the one host sync per iteration
that reading the stop flag costs anyway.
"""

import math

import torch
import torch.nn.functional as F

from tadataka_torch.camera import resize as camera_resize
from tadataka_torch.core.gradients import np_gradient_2d
from tadataka_torch.core.interpolation import interpolate
from tadataka_torch.core.pose import Pose


def calc_jacobian_cols(focal_length, gx, gy, x, y, z):
    """The six columns of the image-gradient pose Jacobian, (N,) each."""
    fx, fy = focal_length[0], focal_length[1]
    fgx, fgy = fx * gx, fy * gy
    z2 = z * z
    xy = x * y
    return (
        fgx / z,
        fgy / z,
        -(fgx * x + fgy * y) / z2,
        -(fgx * xy + fgy * (z2 + y * y)) / z2,
        (fgx * (z2 + x * x) + fgy * xy) / z2,
        (-fgx * y + fgy * x) / z,
    )


def _grid_xy(shape, dtype, device):
    """Flat (N,) pixel-coordinate components."""
    H, W = shape
    Y, X = torch.meshgrid(torch.arange(H, dtype=dtype, device=device),
                          torch.arange(W, dtype=dtype, device=device),
                          indexing="ij")
    return X.ravel(), Y.ravel()


def _in_image_xy(x, y, shape):
    H, W = shape
    return (0.0 <= x) & (x <= W - 1.0) & (0.0 <= y) & (y <= H - 1.0)


_UPPER = torch.triu_indices(6, 6)        # the 21 entries of J^T W J


def fixed_order_sum(x):
    """Sums of x (k, n) over its last axis, halving it pairwise with
    elementwise adds: the same order, and so the same bits, on every
    device (``torch.sum`` and matrix products order their sums by
    device)."""
    n = x.shape[-1]
    x = F.pad(x, (0, (1 << (n - 1).bit_length()) - n))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def _normal_equations(Jt, Jt_upper, upper_rows, w, residuals, mask):
    """J^T W J (6, 6), J^T W r (6,), the sum of squared residuals and the
    number of valid pixels, on the host.  ``Jt`` (6, N) are the Jacobian
    rows, ``Jt_upper`` = Jt[_UPPER[1]] and ``upper_rows`` = _UPPER[0] on
    Jt's device."""
    Jw = Jt * w
    sums = fixed_order_sum(torch.cat([
        Jw[upper_rows] * Jt_upper, Jw * residuals,
        (residuals * residuals)[None], mask.to(w.dtype)[None]])).cpu()
    JtJ = torch.zeros((6, 6), dtype=sums.dtype)
    JtJ[_UPPER[0], _UPPER[1]] = sums[:21]
    JtJ[_UPPER[1], _UPPER[0]] = sums[:21]
    return JtJ, sums[21:27], sums[27], sums[28]


def _estimate_level_ic(camera_model0, camera_model1, I0, D0, I1, weight_map,
                       R10, t10, max_iter, weight_kind):
    """Inverse-compositional Gauss-Newton at one pyramid level; the
    Jacobian lives on the template (frame 0), computed once.  The pose
    composes on the template side: pose10 <- pose10 * exp(xi)^-1.
    The pose is kept on the host; returns (R10, t10) on I0's device."""
    device = I0.device
    ux, uy = _grid_xy(D0.shape, I0.dtype, device)
    x0n, y0n = camera_model0.normalize_xy(ux, uy)
    d0 = D0.ravel()
    p0x, p0y, p0z = x0n * d0, y0n * d0, d0
    GX0, GY0 = np_gradient_2d(I0)
    i0 = I0.ravel()
    wmap = weight_map.ravel()
    focal_length = camera_model0.camera_parameters.focal_length
    Jt = torch.stack(calc_jacobian_cols(
        focal_length, GX0.ravel(), GY0.ravel(), p0x, p0y,
        torch.clamp(p0z, min=1e-6)))
    Jt_upper = Jt[_UPPER[1].to(device)]
    upper_rows = _UPPER[0].to(device)
    eye6 = torch.eye(6, dtype=I0.dtype)

    R, t = R10.cpu(), t10.cpu()
    R_best, t_best = R, t
    prev_error = torch.tensor(float("inf"), dtype=I0.dtype)
    for _ in range(max_iter + 1):
        Rd, td = R.to(device), t.to(device)
        p1x = Rd[0, 0] * p0x + Rd[0, 1] * p0y + Rd[0, 2] * p0z + td[0]
        p1y = Rd[1, 0] * p0x + Rd[1, 1] * p0y + Rd[1, 2] * p0z + td[1]
        p1z = Rd[2, 0] * p0x + Rd[2, 1] * p0y + Rd[2, 2] * p0z + td[2]
        x1 = p1x / (p1z + 1e-16)
        y1 = p1y / (p1z + 1e-16)
        us1x, us1y = camera_model1.unnormalize_xy(x1, y1)
        mask = _in_image_xy(us1x, us1y, I1.shape) & (p1z > 0)
        i1 = interpolate(I1, torch.stack([us1x, us1y], dim=-1))

        residuals = torch.where(mask, i1 - i0, 0.0)   # IC sign convention
        if weight_kind == "map":
            w = torch.where(mask, wmap, 0.0)
        else:
            w = mask.to(I0.dtype)
        JtJ, Jtr, rr, n_valid = _normal_equations(
            Jt, Jt_upper, upper_rows, w, residuals, mask)
        curr_error = rr / torch.clamp(n_valid, min=1.0)
        improved = bool(curr_error < prev_error)
        if improved:
            R_best, t_best, prev_error = R, t, curr_error
        if n_valid == 0 or not improved:
            break
        xi = torch.linalg.solve(JtJ + 1e-12 * eye6, Jtr)
        dpose = Pose.from_se3(xi).inv()
        R, t = R @ dpose.R, (R @ dpose.t) + t
    return R_best.to(device), t_best.to(device)


def _triangle_weights(in_size, out_size):
    """(in, out) float32 weights of the antialiased linear resize,
    computed on the host exactly as ``jax.image.resize(..., "linear")``
    computes its own: a triangle kernel widened by 1/scale when
    downsampling, normalized per output sample."""
    f32 = torch.float32
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = ((torch.arange(out_size, dtype=f32) + 0.5) * inv_scale
                - 0.5)
    x = torch.abs(sample_f[None, :]
                  - torch.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    weights = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = torch.sum(weights, dim=0, keepdim=True)
    weights = torch.where(
        torch.abs(total) > 1000.0 * float(torch.finfo(f32).eps),
        weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


_resize_taps = {}


def resize_taps(in_size, out_size, device):
    """(index (T, out) int64, weight (T, out) float32): each output
    sample's nonzero weights in increasing input order (zero-padded to
    T), built on the host once per size and kept on ``device``."""
    key = (in_size, out_size, torch.device(device))
    taps = _resize_taps.get(key)
    if taps is None:
        w = _triangle_weights(in_size, out_size)
        zero = (w == 0).to(torch.int8)
        n_taps = int((1 - zero).sum(0).max())
        index = torch.argsort(zero, dim=0, stable=True)[:n_taps]
        taps = (index.to(device), torch.gather(w, 0, index).to(device))
        _resize_taps[key] = taps
    return taps


def _sum_taps(terms, dim):
    out = terms.select(dim, 0)
    for k in range(1, terms.shape[dim]):
        out = out + terms.select(dim, k)
    return out


def resize_image(image, shape):
    """Separable antialiased linear resize of an (H, W) image: rows, then
    columns, each output sample the left-to-right sum of its taps."""
    H, W = image.shape
    if (H, W) == tuple(shape):
        return image
    iy, wy = resize_taps(H, shape[0], image.device)
    ix, wx = resize_taps(W, shape[1], image.device)
    rows = _sum_taps(image[iy] * wy[:, :, None], 0)          # (h, W)
    return _sum_taps(rows[:, ix] * wx[None], 1)                # (h, w)


def level_to_scale(level, layer_size_ratio):
    return 1.0 / (layer_size_ratio ** level)


def pyramid_shape(shape, level, layer_size_ratio):
    scale = level_to_scale(level, layer_size_ratio)
    return (max(int(math.ceil(shape[0] * scale)), 8),
            max(int(math.ceil(shape[1] * scale)), 8))


def estimate_pose_pyramid(camera_model0, camera_model1, I0, D0, I1,
                          weight_map, R10, t10, n_levels, max_iter,
                          layer_size_ratio, weight_kind, method="ic"):
    """Coarse-to-fine pose estimation; returns (R10, t10).

    ``weight_kind``: "map" (per-pixel ``weight_map``) or "none"."""
    if method != "ic":
        raise NotImplementedError(
            f"DVO method {method!r} is not ported yet (ROADMAP Queue 1, "
            "'FC DVO')")
    if weight_kind not in ("map", "none"):
        raise NotImplementedError(
            f"DVO weights {weight_kind!r} are not ported yet (ROADMAP "
            "Queue 1, 'robust/weights.py')")
    R, t = R10, t10
    for level in reversed(range(n_levels)):
        scale = level_to_scale(level, layer_size_ratio)
        shape = pyramid_shape(I0.shape, level, layer_size_ratio)
        R, t = _estimate_level_ic(
            camera_resize(camera_model0, scale),
            camera_resize(camera_model1, scale),
            resize_image(I0, shape), resize_image(D0, shape),
            resize_image(I1, shape), resize_image(weight_map, shape),
            R, t, max_iter, weight_kind)
    return R, t
