"""Direct photometric (RGB-D) visual odometry: coarse-to-fine
Gauss-Newton over an image pyramid, inverse-compositional ("ic", the
Jacobian on the template, computed once per level) or
forward-compositional ("fc", I1 and its gradients sampled and the
Jacobian recomputed at every iteration), with per-pixel ("map"), no,
robust ("tukey", "student-t", "huber") or "depth-var" weights
(counterpart of ``tadataka_tpu/vo/dvo.py``).

Each level's loop stops, like the JAX ``lax.while_loop``, after the
first iteration whose photometric error does not improve (or after
``max_iter + 1`` iterations) and returns the best pose seen.

The CPU and the card give the same bits: every sum over pixels is one
fixed-order pairwise reduction (``rounding.fixed_order_sum``), the
pyramid resize sums its few nonzero taps left to right, the robust
weights sort and sum in fixed orders, and the 6x6 float32 solve
(``torch.linalg.solve``, TF32 off) with the pose update runs on the
host.

On a card each level's iteration body (the warp, the bilinear sample,
the residuals, the weights, the Jacobian products and the fixed-order
sums of the normal equations) is one CUDA graph: a ``_LevelGraph``,
kept in ``_graphs`` per device, stream, level shape, method, weight kind
and distortion, captured on the first call that meets that key and
replayed on every iteration after.  The graph replays the kernels the
eager body launches, so the bits stay those of the CPU.  Each level's
template stage copies its outputs into the graph's static inputs; the
pose goes in through a pinned host buffer without blocking.  So each
iteration synchronizes the host once, to fetch the 29 sums that the
stop test needs; each level adds the pose's fetch, the best pose's
upload and the upper-triangle index (``sync.dvo.*`` marks).
"""

import math
from functools import partial

import numpy as np
import torch

from tadataka_torch.camera import resize as camera_resize
from tadataka_torch.core.gradients import np_gradient_2d
from tadataka_torch.core.interpolation import interpolate
from tadataka_torch.core.pose import Pose
from tadataka_torch.core.rounding import as_divisor, fixed_order_sum
from tadataka_torch.robust.weights import (
    compute_weights_huber, compute_weights_student_t, compute_weights_tukey)
from tadataka_torch.utils.timing import count, span, sync_point

WEIGHT_KINDS = ("none", "map", "depth-var", "tukey", "student-t", "huber")
METHODS = ("ic", "fc")


def calc_jacobian(focal_length, gx, gy, P):
    """The image-gradient pose Jacobian rows (N, 6) for points P (N, 3)
    in frame 1 and the gradients gx, gy (N,) of I1 sampled there."""
    return torch.stack(calc_jacobian_cols(focal_length, gx, gy, P[:, 0],
                                          P[:, 1], P[:, 2]), dim=-1)


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


def _upper_index(device):
    """(columns, rows) of ``_UPPER`` on ``device``."""
    with sync_point("sync.dvo.upper_index", 2):
        return _UPPER[1].to(device), _UPPER[0].to(device)


def _normal_sums(Jt, Jt_upper, upper_rows, w, residuals, mask):
    """The device half of the normal equations: one (29,) tensor on Jt's
    device of the 21 entries of J^T W J's upper triangle, J^T W r (6),
    the sum of squared residuals and the number of valid pixels.  ``Jt``
    (6, N) are the Jacobian rows, ``Jt_upper`` = Jt[_UPPER[1]] and
    ``upper_rows`` = _UPPER[0] on Jt's device."""
    Jw = Jt * w
    return fixed_order_sum(torch.cat([
        Jw[upper_rows] * Jt_upper, Jw * residuals,
        (residuals * residuals)[None], mask.to(w.dtype)[None]]))


def _normal_equations(sums):
    """The host half: J^T W J (6, 6), J^T W r (6,), the sum of squared
    residuals and the number of valid pixels, on the host, from the
    (29,) sums of :func:`_normal_sums`."""
    with sync_point("sync.dvo.sums"):
        sums = sums.cpu()
    JtJ = torch.zeros((6, 6), dtype=sums.dtype)
    JtJ[_UPPER[0], _UPPER[1]] = sums[:21]
    JtJ[_UPPER[1], _UPPER[0]] = sums[:21]
    return JtJ, sums[21:27], sums[27], sums[28]


_SIGMA_I2 = 1e-3   # photometric noise floor of "depth-var" ([0, 1] images)


def _resolve_weights(weight_kind, residuals, weight_map, mask, dr_dq=None):
    """Per-pixel weights, 0 on masked lanes.  "depth-var" is LSD-SLAM's
    tracking weight 1 / (sigma_I^2 + (dr/dq)^2 Var[q]), q the inverse
    depth, with ``weight_map`` carrying Var[q]."""
    if weight_kind == "none":
        return mask.to(residuals.dtype)
    if weight_kind == "map":
        return torch.where(mask, weight_map, 0.0)
    if weight_kind == "depth-var":
        w = as_divisor(1.0, dr_dq) / (_SIGMA_I2 + dr_dq * dr_dq * weight_map)
        return torch.where(mask, w, 0.0)
    if weight_kind == "tukey":
        return compute_weights_tukey(residuals, mask=mask)
    if weight_kind == "student-t":
        return compute_weights_student_t(residuals, mask=mask)
    if weight_kind == "huber":
        return compute_weights_huber(residuals, mask=mask)
    raise ValueError(f"No such weights '{weight_kind}'")


def _template_points(camera_model0, D0, grid):
    """Frame-0 points (p0x, p0y, p0z) at the pixel grid, from the
    normalized grid ``grid`` (x0n, y0n) or, without one, normalizing the
    pixel coordinates here."""
    if grid is None:
        grid = camera_model0.normalize_xy(
            *_grid_xy(D0.shape, D0.dtype, D0.device))
    x0n, y0n = grid
    d0 = D0.ravel()
    return x0n * d0, y0n * d0, d0


def _warp_points(R, t, p0x, p0y, p0z, camera_model1, shape):
    """Frame-0 points through (R, t) (on the points' device) into frame
    1: (p1x, p1y, p1z, us1x, us1y, mask)."""
    p1x = R[0, 0] * p0x + R[0, 1] * p0y + R[0, 2] * p0z + t[0]
    p1y = R[1, 0] * p0x + R[1, 1] * p0y + R[1, 2] * p0z + t[1]
    p1z = R[2, 0] * p0x + R[2, 1] * p0y + R[2, 2] * p0z + t[2]
    x1 = p1x / (p1z + 1e-16)
    y1 = p1y / (p1z + 1e-16)
    us1x, us1y = camera_model1.unnormalize_xy(x1, y1)
    mask = _in_image_xy(us1x, us1y, shape) & (p1z > 0)
    return p1x, p1y, p1z, us1x, us1y, mask


def _leaves(x):
    """The tensors of a body input: a tensor, or a (named) tuple of them
    such as a camera model."""
    if isinstance(x, torch.Tensor):
        return [x]
    return [leaf for part in x for leaf in _leaves(part)]


def _empty_like(x):
    if isinstance(x, torch.Tensor):
        return torch.empty_like(x)
    return type(x)(*map(_empty_like, x))


class _LevelGraph:
    """A level's iteration body on a card, captured as a CUDA graph over
    static copies of its inputs and of the pose, and replayed on every
    iteration.  ``load`` copies a level call's inputs in (on the current
    stream, after what the caller issued there); a call stages the host
    pose in pinned memory, copies it in without blocking and replays.
    Reusing the staging buffer is safe: every replay is followed by the
    fetch of its sums (``_normal_equations``), which drains the stream."""

    def __init__(self, body, inputs, pose_dtype):
        self.body = body
        self.inputs = {name: _empty_like(x) for name, x in inputs.items()}
        self.device = inputs["I1"].device
        self.pose = torch.empty(12, dtype=pose_dtype, device=self.device)
        self.staging = torch.empty(12, dtype=pose_dtype, pin_memory=True)
        self.graph = self.sums = None

    def load(self, inputs):
        for name, x in inputs.items():
            for static, value in zip(_leaves(self.inputs[name]),
                                     _leaves(x)):
                static.copy_(value)

    def _body(self):
        return self.body(self.pose[:9].view(3, 3), self.pose[9:],
                         **self.inputs)

    def _capture(self):
        # one eager run first, on a side stream: lazy set-up (a table
        # made on first use, a library handle) may not run in a capture
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._body()
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            sums = self._body()
        self.graph, self.sums = graph, sums
        count("dvo.graph_capture")

    def __call__(self, R, t):
        """The (29,) sums at the host pose (R, t), on the card."""
        self.staging[:9].copy_(R.reshape(-1))
        self.staging[9:].copy_(t)
        with torch.cuda.device(self.device):
            self.pose.copy_(self.staging, non_blocking=True)
            if self.graph is None:
                self._capture()
            self.graph.replay()
        count("dvo.graph_replay")
        return self.sums


_graphs = {}   # (device, stream, method, weight kind, ...) -> _LevelGraph


def _level_iteration(body, inputs, method, weight_kind, pose_dtype):
    """``iteration(R, t)``: the (29,) normal-equation sums of
    ``body(R, t, **inputs)`` at the host pose (R, t), on the inputs'
    device.  The CPU runs the body eagerly; a card replays the graph of
    the level's key, captured on the first call that meets it."""
    device = inputs["I1"].device
    if device.type != "cuda":
        return lambda R, t: body(R, t, **inputs)
    key = (device, torch.cuda.current_stream(device).cuda_stream, method,
           weight_kind, type(inputs["camera_model1"].distortion_model),
           pose_dtype, tuple((name, x.dtype, tuple(x.shape))
                             for name, value in inputs.items()
                             for x in _leaves(value)))
    graph = _graphs.get(key)
    if graph is None:
        graph = _graphs[key] = _LevelGraph(body, inputs, pose_dtype)
    graph.load(inputs)
    return graph


def _gauss_newton(R10, t10, max_iter, device, iteration, compose):
    """The Gauss-Newton loop with the error-increase stop, the pose on
    the host.  ``iteration(R, t)`` (R, t on the host) returns the normal
    equations' (29,) sums on ``device``; ``compose(R, t, xi)`` applies
    the step.  Returns the best (R10, t10) seen, on ``device``."""
    with sync_point("sync.dvo.pose_to_host", 2):
        R, t = R10.cpu(), t10.cpu()
    eye6 = torch.eye(6, dtype=R.dtype)
    R_best, t_best = R, t
    prev_error = torch.tensor(float("inf"), dtype=R.dtype)
    for _ in range(max_iter + 1):
        with span("dvo.gn_iter"):
            count("dvo.gn_iter")
            JtJ, Jtr, rr, n_valid = _normal_equations(iteration(R, t))
            curr_error = rr / torch.clamp(n_valid, min=1.0)
            improved = bool(curr_error < prev_error)
            if improved:
                R_best, t_best, prev_error = R, t, curr_error
            if n_valid == 0 or not improved:
                break
            with span("dvo.solve"):
                R, t = compose(R, t,
                               torch.linalg.solve(JtJ + 1e-12 * eye6, Jtr))
    with sync_point("sync.dvo.best_to_card", 2):
        return R_best.to(device), t_best.to(device)


def _ic_sums(weight_kind, R, t, camera_model1, p0x, p0y, p0z, i0, I1, wmap,
             Jt, Jt_upper, upper_rows, gx0, gy0, focal_length):
    """The inverse-compositional iteration body: the normal-equation sums
    at (R, t), the Jacobian fixed on the template."""
    p1x, p1y, p1z, us1x, us1y, mask = _warp_points(
        R, t, p0x, p0y, p0z, camera_model1, I1.shape)
    i1 = interpolate(I1, torch.stack([us1x, us1y], dim=-1))
    residuals = torch.where(mask, i1 - i0, 0.0)   # IC sign convention
    dr_dq = None
    if weight_kind == "depth-var":
        # d(residual)/d(inverse depth): the template gradient dotted
        # with the warp's depth derivative
        z2 = p1z * p1z + 1e-12
        dxdq = p0z * (t[0] * p1z - t[2] * p1x) / z2
        dydq = p0z * (t[1] * p1z - t[2] * p1y) / z2
        dr_dq = (focal_length[0] * gx0 * dxdq
                 + focal_length[1] * gy0 * dydq)
    w = _resolve_weights(weight_kind, residuals, wmap, mask, dr_dq)
    return _normal_sums(Jt, Jt_upper, upper_rows, w, residuals, mask)


def _estimate_level_ic(camera_model0, camera_model1, I0, D0, I1, weight_map,
                       R10, t10, max_iter, weight_kind, grid=None):
    """Inverse-compositional Gauss-Newton at one pyramid level; the
    Jacobian lives on the template (frame 0), computed once.  The pose
    composes on the template side: pose10 <- pose10 * exp(xi)^-1.
    ``grid``: the level's normalized pixel grid (see
    :func:`normalized_grids`).  Returns (R10, t10) on I0's device."""
    device = I0.device
    with span("dvo.template"):
        p0x, p0y, p0z = _template_points(camera_model0, D0, grid)
        GX0, GY0 = np_gradient_2d(I0)
        gx0, gy0 = GX0.ravel(), GY0.ravel()
        focal_length = camera_model0.camera_parameters.focal_length
        Jt = torch.stack(calc_jacobian_cols(
            focal_length, gx0, gy0, p0x, p0y, torch.clamp(p0z, min=1e-6)))
        upper_cols, upper_rows = _upper_index(device)
        inputs = dict(camera_model1=camera_model1, p0x=p0x, p0y=p0y,
                      p0z=p0z, i0=I0.ravel(), I1=I1, wmap=weight_map.ravel(),
                      Jt=Jt, Jt_upper=Jt[upper_cols], upper_rows=upper_rows,
                      gx0=gx0, gy0=gy0, focal_length=focal_length)
        iteration = _level_iteration(partial(_ic_sums, weight_kind), inputs,
                                     "ic", weight_kind, R10.dtype)

    def compose(R, t, xi):
        dpose = Pose.from_se3(xi).inv()
        return R @ dpose.R, (R @ dpose.t) + t

    return _gauss_newton(R10, t10, max_iter, device, iteration, compose)


def _fc_sums(weight_kind, R, t, camera_model1, p0x, p0y, p0z, i0, I1, wmap,
             GX1, GY1, upper_cols, upper_rows):
    """The forward-compositional iteration body: I1 and its gradients
    sampled at the warped points and the Jacobian recomputed there; the
    normal-equation sums at (R, t)."""
    focal_length = camera_model1.camera_parameters.focal_length
    p1x, p1y, p1z, us1x, us1y, mask = _warp_points(
        R, t, p0x, p0y, p0z, camera_model1, I1.shape)
    us1 = torch.stack([us1x, us1y], dim=-1)
    i1 = interpolate(I1, us1)
    gx1 = interpolate(GX1, us1)
    gy1 = interpolate(GY1, us1)
    # r = I0(u0) - I1(warp(u0)), recomputed at every iteration
    residuals = torch.where(mask, i0 - i1, 0.0)
    # masked lanes get z = 1, keeping J finite
    p1z_safe = torch.where(mask, p1z, 1.0)
    Jt = torch.stack(calc_jacobian_cols(focal_length, gx1, gy1, p1x, p1y,
                                        p1z_safe))
    dr_dq = None
    if weight_kind == "depth-var":
        z2 = p1z_safe * p1z_safe
        dxdq = p0z * (t[0] * p1z_safe - t[2] * p1x) / z2
        dydq = p0z * (t[1] * p1z_safe - t[2] * p1y) / z2
        dr_dq = (focal_length[0] * gx1 * dxdq
                 + focal_length[1] * gy1 * dydq)
    w = _resolve_weights(weight_kind, residuals, wmap, mask, dr_dq)
    return _normal_sums(Jt, Jt[upper_cols], upper_rows, w, residuals, mask)


def _estimate_level(camera_model0, camera_model1, I0, D0, I1, weight_map,
                    R10, t10, max_iter, weight_kind, grid=None):
    """Forward-compositional Gauss-Newton at one pyramid level: every
    iteration samples I1 and its gradients at the warped points and
    recomputes the Jacobian there; the step composes on the left,
    pose10 <- exp(xi) * pose10.  Returns (R10, t10) on I0's device."""
    device = I0.device
    p0x, p0y, p0z = _template_points(camera_model0, D0, grid)
    GX1, GY1 = np_gradient_2d(I1)
    upper_cols, upper_rows = _upper_index(device)
    inputs = dict(camera_model1=camera_model1, p0x=p0x, p0y=p0y, p0z=p0z,
                  i0=I0.ravel(), I1=I1, wmap=weight_map.ravel(), GX1=GX1,
                  GY1=GY1, upper_cols=upper_cols, upper_rows=upper_rows)
    iteration = _level_iteration(partial(_fc_sums, weight_kind), inputs,
                                 "fc", weight_kind, R10.dtype)

    def compose(R, t, xi):
        dpose = Pose.from_se3(xi)
        return dpose.R @ R, (dpose.R @ t) + dpose.t

    return _gauss_newton(R10, t10, max_iter, device, iteration, compose)


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
                          layer_size_ratio, weight_kind, method="ic",
                          grids=None):
    """Coarse-to-fine pose estimation; returns (R10, t10).

    ``weight_kind``: one of ``WEIGHT_KINDS`` ("map" and "depth-var" read
    ``weight_map``: the weights, or the inverse-depth variance).
    ``method``: "ic" or "fc".  ``grids``: the per-level normalized pixel
    grids of :func:`normalized_grids` (finest last), or None to
    normalize them at every level of every call."""
    if method not in METHODS:
        raise ValueError(f"No such DVO method '{method}'")
    if weight_kind not in WEIGHT_KINDS:
        raise ValueError(f"No such weights '{weight_kind}'")
    level_fn = _estimate_level_ic if method == "ic" else _estimate_level
    R, t = R10, t10
    for k, level in enumerate(reversed(range(n_levels))):
        with span("dvo.level", level=level):
            scale = level_to_scale(level, layer_size_ratio)
            shape = pyramid_shape(I0.shape, level, layer_size_ratio)
            with span("dvo.resize"):
                images = [resize_image(x, shape)
                          for x in (I0, D0, I1, weight_map)]
            R, t = level_fn(
                camera_resize(camera_model0, scale),
                camera_resize(camera_model1, scale), *images,
                R, t, max_iter, weight_kind,
                grid=None if grids is None else grids[k])
    return R, t


def normalized_grids(camera_model0, n_levels, layer_size_ratio, shape):
    """Per-level (x0n, y0n) normalized template grids for
    :func:`estimate_pose_pyramid`, finest level last, on the camera's
    device: the undistortion table of the pyramid (for RadTan a Newton
    loop over every pixel, the same on every frame)."""
    device = camera_model0.camera_parameters.focal_length.device
    grids = []
    for level in reversed(range(n_levels)):
        scale = level_to_scale(level, layer_size_ratio)
        cm0 = camera_resize(camera_model0, scale)
        grids.append(cm0.normalize_xy(*_grid_xy(
            pyramid_shape(shape, level, layer_size_ratio), torch.float32,
            device)))
    return tuple(grids)


class PoseChangeEstimator:
    """Coarse-to-fine DVO pose estimator: 5 levels, size ratio 1.5, at
    most 20 Gauss-Newton iterations a level by default; weights None,
    a per-pixel map, or one of "tukey", "student-t", "huber",
    "depth-var" (with a ones map), "map" or "none".  The normalized grids
    are computed once per image shape.  Runs on the camera models'
    device."""

    def __init__(self, camera_model0, camera_model1, n_coarse_to_fine=5,
                 max_iter=20, layer_size_ratio=1.5, method="ic"):
        if method not in METHODS:
            raise ValueError(f"No such DVO method '{method}'")
        self.camera_model0 = camera_model0
        self.camera_model1 = camera_model1
        self.n_coarse_to_fine = n_coarse_to_fine
        self.max_iter = max_iter
        self.layer_size_ratio = layer_size_ratio
        self.method = method
        self.device = camera_model0.camera_parameters.focal_length.device
        self._grids = {}      # image shape -> per-level normalized grids

    def grids(self, shape):
        """The per-level normalized grids of an image shape (cached)."""
        shape = tuple(shape)
        grids = self._grids.get(shape)
        if grids is None:
            grids = normalized_grids(self.camera_model0,
                                     self.n_coarse_to_fine,
                                     self.layer_size_ratio, shape)
            self._grids[shape] = grids
        return grids

    def __call__(self, I0, D0, I1, weights=None, pose10=None):
        def f32(x):
            if not isinstance(x, torch.Tensor):
                x = np.array(x, dtype=np.float32)
            return torch.as_tensor(x, dtype=torch.float32, device=self.device)

        I0, D0, I1 = f32(I0), f32(D0), f32(I1)
        if not I0.shape == D0.shape == I1.shape:
            raise ValueError(f"I0, D0 and I1 differ in shape: {I0.shape}, "
                             f"{D0.shape}, {I1.shape}")
        if pose10 is None:
            pose10 = Pose.identity(device=self.device)
        if isinstance(weights, str):
            weight_kind, weight_map = weights, torch.ones_like(I0)
        elif weights is None:
            weight_kind, weight_map = "none", torch.ones_like(I0)
        else:
            weight_kind, weight_map = "map", f32(weights)
        R, t = estimate_pose_pyramid(
            self.camera_model0, self.camera_model1, I0, D0, I1, weight_map,
            pose10.R, pose10.t, self.n_coarse_to_fine, self.max_iter,
            self.layer_size_ratio, weight_kind, self.method,
            self.grids(I0.shape))
        return Pose(R, t)
