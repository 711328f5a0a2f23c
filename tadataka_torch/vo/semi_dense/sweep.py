"""Plane-sweep semi-dense depth update (counterpart of
``tadataka_tpu/vo/semi_dense/sweep.py``).

For inverse depth q, every key pixel's epipolar sample in the ref image
is x_ref = pi(R x~ + q t): all pixels' samples at one q form one
plane-induced homography warp H_q = K_ref (R + q t e3^T) K_key^-1 of the
ref image.  Sweeping S planes gives a (S, H, W) volume whose plane axis
is each pixel's epipolar line; a five-plane window search along it
(``ssd_search``, a CUDA kernel on the card) finds the match, which is
refined by a parabola through the neighbouring window errors.

The port keeps the gather forms of the JAX package: ``warp_plane_stack``
(two-pass homography warps) and the ``budget=0`` key patch.  The tent
budgets of the TPU path do not exist here; the planner's plane counts
and redirects (``fast.py``) still choose the planes and refframes.
"""

from pathlib import Path

import torch
import torch.nn.functional as F

from tadataka_torch.flags import Flag
from tadataka_torch.core.gradients import sobel_x, sobel_y
from tadataka_torch.core.rounding import as_divisor, matmul_small, sqrt
from tadataka_torch.core.transforms import (
    get_rotation, get_translation, inv_motion_matrix)
from tadataka_torch.core.warp2pass import homography_warp, displacement_warp
from tadataka_torch.vo.semi_dense.estimator import (
    EPSILON, safe_invert, pixel_geometry_map, _photo_var, calc_key_epipole)
from tadataka_torch.vo.semi_dense.fusion import fusion
from tadataka_torch.vo.semi_dense.hypothesis import (
    clamped_range, check_args_flag)
from tadataka_torch.vo.semi_dense.params import N_KEY_SAMPLES
from tadataka_torch.utils.timing import sync_point

DEFAULT_N_PLANES = 64
_INF = 3.0e38


# ------------------------------------------------------------ plane warps

def plane_homography(T_rk, q, key_focal, key_offset, ref_focal, ref_offset):
    """Pixel-space homographies key -> ref of the inverse-depth planes q
    (a 0-d tensor or (S,)): K_ref (R + q t e3^T) K_key^-1, (..., 3, 3)."""
    dtype, device = T_rk.dtype, T_rk.device
    R = get_rotation(T_rk)
    t = get_translation(T_rk)
    with sync_point("sync.sweep.e3"):
        e3 = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=device)
    q = torch.as_tensor(q, dtype=dtype, device=device)[..., None, None]
    A = R + q * t[:, None] * e3[None, :]
    zero = torch.zeros((), dtype=dtype, device=device)
    one = torch.ones((), dtype=dtype, device=device)
    K_ref = torch.stack([
        torch.stack([ref_focal[0], zero, ref_offset[0]]),
        torch.stack([zero, ref_focal[1], ref_offset[1]]),
        torch.stack([zero, zero, one])])
    K_key_inv = torch.stack([
        torch.stack([1.0 / key_focal[0], zero, -key_offset[0] / key_focal[0]]),
        torch.stack([zero, 1.0 / key_focal[1], -key_offset[1] / key_focal[1]]),
        torch.stack([zero, zero, one])])
    return matmul_small(matmul_small(K_ref, A), K_key_inv)


def warp_plane_stack(ref_image, T_rk, qs, key_focal, key_offset,
                     ref_focal, ref_offset, cols=None):
    """(S, H, W) stack of the ref image warped onto the key grid at each
    inverse-depth plane qs (S,); out-of-image / behind-camera lanes hold
    -1.  All planes are warped in one batched two-pass gather.  ``cols =
    (x0, w)``: only the key grid's columns x0 .. x0+w-1, (S, H, w)."""
    H33 = plane_homography(T_rk, qs, key_focal, key_offset,
                           ref_focal, ref_offset)
    stack, _ = homography_warp(ref_image, H33, fill=-1.0, cols=cols)
    return stack


# ----------------------------------------------------------- SSD search

def _check_ssd_inputs(V, K, mlo, mhi):
    if V.dim() != 3 or K.dim() != 3 or mlo.dim() != 2 or mhi.dim() != 2:
        raise ValueError("ssd_search wants V (S,H,W), K (5,H,W), "
                         "mlo/mhi (H,W)")
    S, H, W = V.shape
    if K.shape[0] != N_KEY_SAMPLES or S < N_KEY_SAMPLES:
        raise ValueError(f"ssd_search wants K.shape[0] == {N_KEY_SAMPLES} "
                         f"and S >= {N_KEY_SAMPLES}, got K {tuple(K.shape)}"
                         f", S {S}")
    for name, x in (("K", K), ("mlo", mlo), ("mhi", mhi)):
        if tuple(x.shape[-2:]) != (H, W):
            raise ValueError(f"ssd_search: {name} is {tuple(x.shape)}, "
                             f"V is {tuple(V.shape)}")
    for name, x in (("V", V), ("K", K), ("mlo", mlo), ("mhi", mhi)):
        if x.dtype != torch.float32:
            raise TypeError(f"ssd_search: {name} must be float32, "
                            f"got {x.dtype}")
        if x.device != V.device:
            raise ValueError(f"ssd_search: {name} is on {x.device}, "
                             f"V on {V.device}")


def _window_errors(V, K, mlo, mhi):
    """(M, H, W) masked normalized-SSD errors of the M = S-4 windows.

    Sums run left to right with every product rounded on its own — the
    kernel's arithmetic exactly."""
    M = V.shape[0] - N_KEY_SAMPLES + 1
    w = [V[k:k + M] for k in range(N_KEY_SAMPLES)]
    kk = K[0] * K[0]
    corr = w[0] * K[0]
    wn2 = w[0] * w[0]
    valid = w[0] >= 0.0
    for k in range(1, N_KEY_SAMPLES):
        kk = kk + K[k] * K[k]
        corr = corr + w[k] * K[k]
        wn2 = wn2 + w[k] * w[k]
        valid = valid & (w[k] >= 0.0)
    Kn = sqrt(kk) + EPSILON
    mf = torch.arange(M, dtype=V.dtype, device=V.device)[:, None, None]
    valid = valid & (mf >= mlo) & (mf <= mhi)
    err = 2.0 - 2.0 * corr / (sqrt(wn2) * Kn + EPSILON)
    return torch.where(valid, err, _INF)


def _take(x, index):
    return torch.take_along_dim(x, index[None], dim=0)[0]


def _serial_scan(errs):
    """The serial scan of the Pallas kernel (``_ssd_kernel``,
    tadataka_tpu/vo/semi_dense/sweep.py:222-230) over the window errors
    (M, H, W), in closed form.  The scan keeps a running minimum from
    3e38 with strict ``<`` (the earliest window wins a tie) and takes it
    with ``jnp.minimum``, which turns NaN at the first NaN error and
    stays NaN, so no window from the first NaN one (n0) on becomes the
    best.  So: the first-index argmin of the errors with every window
    from n0 on ranked 3e38; ep the previous window's error and en the
    next one's (3e38 outside the windows; en may be the NaN of window
    n0).  A pixel with no error below 3e38 before n0 has no best: (-1,
    3e38, 3e38, window 0's error), as the scan leaves en at m = 0."""
    M = errs.shape[0]
    poisoned = torch.cumsum(torch.isnan(errs), dim=0) > 0
    ranked = torch.where(poisoned, _INF, errs)
    best = torch.argmin(ranked, dim=0)
    none = _take(ranked, best) >= _INF
    ep = torch.where(best == 0, _INF, _take(errs, torch.clamp(best - 1,
                                                              min=0)))
    en = torch.where(best == M - 1, _INF,
                     _take(errs, torch.clamp(best + 1, max=M - 1)))
    return (torch.where(none, -1, best).to(torch.int32),
            torch.where(none, _INF, _take(errs, best)),
            torch.where(none, _INF, ep), torch.where(none, errs[0], en))


def ssd_search_reference(V, K, mlo, mhi):
    """Plain PyTorch version of the SSD window search: the error volume
    and the Pallas kernel's serial scan over it (:func:`_serial_scan`),
    so NaN errors are placed as on the TPU.  Wherever no window's error
    is NaN or reaches 3e38 unmasked it equals the XLA search
    (``_ssd_search_xla``): the first-index argmin and its neighbours.

    Returns (best (H,W) int32 with -1 = no valid window, err_center,
    err_prev, err_next); a neighbour outside the windows is 3e38."""
    return _serial_scan(_window_errors(V, K, mlo, mhi))


def ssd_window_bounds(mlo, mhi, S):
    """(m_lo, m_hi) int32: the windows max(0, ceil(mlo)) .. min(M - 1,
    floor(mhi)) that the search may score, M = S - 4, clamped in float
    before the conversion; NaN in either bound gives (M, -1).  The range
    is empty where m_lo > m_hi.  Window m of a pixel is in range exactly
    where ``m >= mlo and m <= mhi`` holds in float32, so the pixel's
    outputs depend only on planes m_lo .. m_hi + 4.  The ring kernel
    computes the same bounds (csrc/ssd_search.cu, ``window_bounds``)."""
    M = S - N_KEY_SAMPLES + 1
    nan = torch.isnan(mlo) | torch.isnan(mhi)
    lo = torch.clamp(torch.ceil(mlo), 0.0, float(M))
    hi = torch.clamp(torch.floor(mhi), -1.0, float(M - 1))
    return (torch.where(nan, float(M), lo).to(torch.int32),
            torch.where(nan, -1.0, hi).to(torch.int32))


_SSD_SOURCE = Path(__file__).parent / "csrc" / "ssd_search.cu"
_ssd_library = None


def bind_ssd_library(built):
    """Declare the C signatures of a built ``csrc/ssd_search.cu``."""
    import ctypes
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    launch = [ptr] * 4 + [i32] * 3 + [ptr] * 5
    built.lib.ssd_search_ring_launch.argtypes = launch
    built.lib.ssd_search_ring_config.argtypes = [i32] * 3 + [ptr]
    for fn in (built.lib.ssd_search_ring_launch,
               built.lib.ssd_search_ring_config):
        fn.restype = i32
    return built


def ssd_library():
    """Build (at first use) and load the SSD search kernel library."""
    global _ssd_library
    if _ssd_library is None:
        from tadataka_torch.cuda_build import build
        _ssd_library = bind_ssd_library(build(_SSD_SOURCE))
    return _ssd_library


def ring_config(S, H, W, library=None):
    """The ring kernel's launch plan on the current card: a dict of the
    tile size P (pixels), tiles, grid, blocks an SM, dynamic shared
    memory a block (bytes), threads a block, ``ring``: 1 if the shape
    takes the ring (H*W % 4 == 0; else the "thread" kernel runs), and
    ``shape``: the compiled (consumer threads, planes a stage, stages,
    blocks an SM at most).  ``library``: a build of the source other than
    the package's (the shape sweep's)."""
    import ctypes
    out = (ctypes.c_int * 11)()
    lib = (library or ssd_library()).lib
    status = lib.ssd_search_ring_config(S, H, W, out)
    if status != 0:
        raise RuntimeError(f"ssd_search ring: no plan for S={S} {H}x{W}: "
                           f"CUDA error {status}")
    plan = dict(zip(("tile", "tiles", "grid", "blocks_per_sm",
                     "shared_bytes", "threads", "ring"), out[:7]))
    plan["shape"] = tuple(out[7:])
    return plan


def _launch(V, K, mlo, mhi, library=None):
    """Launch the search on the current stream (``library``: as in
    :func:`ring_config`); returns its outputs and raises if the launch
    failed."""
    S, H, W = V.shape
    fn = (library or ssd_library()).lib.ssd_search_ring_launch
    best = torch.empty((H, W), dtype=torch.int32, device=V.device)
    ec, ep, en = (torch.empty((H, W), dtype=torch.float32, device=V.device)
                  for _ in range(3))
    with torch.cuda.device(V.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(V.data_ptr(), K.data_ptr(), mlo.data_ptr(),
                    mhi.data_ptr(), S, H, W, best.data_ptr(), ec.data_ptr(),
                    ep.data_ptr(), en.data_ptr(), stream)
    if status != 0:
        raise RuntimeError(f"ssd_search kernel launch failed: CUDA error "
                           f"{status}")
    return best, ec, ep, en


def ssd_search(V, K, mlo, mhi):
    """Masked normalized-SSD window search over the plane volume.

    V (S,H,W) float32 with -1 = invalid sample, K (5,H,W) key patch,
    mlo/mhi (H,W) valid window bounds.  Returns (best (H,W) int32, -1 =
    no valid window; err_center, err_prev, err_next (H,W) float32).

    A CUDA tensor launches the hand-written kernel (csrc/ssd_search.cu):
    a persistent grid streaming only the planes each tile's bounds allow
    through a shared-memory ring of TMA copies.  A tensor map needs H*W
    % 4 == 0 and inputs on the 16-byte grid; on other inputs the launcher
    runs the first kernel, one thread per pixel over every plane, which
    gives the same bits (:func:`ring_config` says which a shape takes).
    A CPU tensor runs :func:`ssd_search_reference`.  No fallback: any
    other input or a failed launch raises.
    """
    _check_ssd_inputs(V, K, mlo, mhi)
    if V.device.type == "cpu":
        return ssd_search_reference(V, K, mlo, mhi)
    if V.device.type != "cuda":
        raise ValueError(f"ssd_search: no kernel for device {V.device}")
    for name, x in (("V", V), ("K", K), ("mlo", mlo), ("mhi", mhi)):
        if not x.is_contiguous():
            raise ValueError(f"ssd_search: {name} must be contiguous")
    out = _launch(V, K, mlo, mhi)
    ssd_search.launches += 1
    return out


ssd_search.launches = 0   # kernel launches; the CPU path never counts


# ------------------------------------------------------------- key patch

def _key_patch_stack(key_image, key_focal, step_size_map, dir_x_map,
                     dir_y_map, cols=None):
    """(5, H, W) key-patch samples at offsets -2..2 along the per-pixel
    epipolar direction, via two-pass displacement warps.  ``cols = (x0,
    w)``: the maps are the (H, w) block of key columns x0 .. x0+w-1, and
    the samples are taken from the whole key image."""
    half = N_KEY_SAMPLES // 2
    planes = []
    for k in range(-half, half + 1):
        if k == 0:
            planes.append(key_image if cols is None
                          else key_image[:, cols[0]:cols[0] + cols[1]])
            continue
        dx = k * step_size_map * dir_x_map * key_focal[0]
        dy = k * step_size_map * dir_y_map * key_focal[1]
        warped, _ = displacement_warp(key_image, dx, dy, cols=cols)
        planes.append(warped)
    return torch.stack(planes)


# ----------------------------------------------------- shared postprocess

def postprocess_map(q_m, nomatch, kgrad, ks, gx_v, gy_v, g, p_inv,
                    p_var, T_rk, age, *, params, fuse_prior=False):
    """Depth / variance / flag arrays from the matched inverse depth
    ``q_m`` over the whole map, for ONE refframe's T_rk (callers merge
    the active refframes by age index).  All array arguments are flat
    (N,); ``g`` is a PixelGeoScalars of (N,) fields."""
    R = get_rotation(T_rk)
    t = get_translation(T_rk)
    xk_x, xk_y = g.x_key_x, g.x_key_y
    r0 = R[0, 0] * xk_x + R[0, 1] * xk_y + R[0, 2]
    r1 = R[1, 0] * xk_x + R[1, 1] * xk_y + R[1, 2]
    r2 = R[2, 0] * xk_x + R[2, 1] * xk_y + R[2, 2]

    def warp_xy(depth):
        z = depth * r2 + t[2]
        return ((depth * r0 + t[0]) / (z + EPSILON),
                (depth * r1 + t[1]) / (z + EPSILON))

    def unit(x, y, n):
        z = n == 0.0
        n = torch.where(z, 1.0, n)
        return torch.where(z, x, x / n), torch.where(z, y, y / n)

    flag_insufficient = kgrad < params.min_gradient
    key_depth = safe_invert(q_m)
    new_inv_depth = q_m

    # d(inverse depth)/d(epipolar position), componentwise
    xmin_x, xmin_y = warp_xy(g.min_depth)
    xmax_x, xmax_y = warp_xy(g.max_depth)
    ddx = xmax_x - xmin_x
    ddy = xmax_y - xmin_y
    dirx, diry = unit(ddx, ddy, sqrt(ddx * ddx + ddy * ddy))
    xr_x, xr_y = warp_xy(key_depth)
    num0 = r2 * t[0] - r0 * t[2]
    den0 = xr_x * t[2] - t[0]
    a_x = dirx * num0 / (den0 * den0 + EPSILON)
    num1 = r2 * t[1] - r1 * t[2]
    den1 = xr_y * t[2] - t[1]
    a_y = diry * num1 / (den1 * den1 + EPSILON)
    alpha = torch.where(torch.abs(dirx) > torch.abs(diry), a_x, a_y)

    # geometric variance 1 / <epipolar direction, gradient>^2
    ex = xk_x - t[0] / (t[2] + EPSILON)
    ey = xk_y - t[1] / (t[2] + EPSILON)
    exn, eyn = unit(ex, ey, sqrt(ex * ex + ey * ey))
    gxn, gyn = unit(gx_v, gy_v, sqrt(gx_v * gx_v + gy_v * gy_v))
    p = exn * gxn + eyn * gyn
    geo_v = torch.where(p == 0.0, 1.0 / EPSILON, 1.0 / (p * p + EPSILON))

    photo = _photo_var(kgrad / (ks + EPSILON))
    a2 = alpha * alpha
    variance = a2 * (params.geo_coeff ** 2 * geo_v
                     + params.photo_coeff ** 2 * photo)

    flag = check_args_flag(new_inv_depth, variance, params.min_inv_depth,
                           params.max_inv_depth)
    # priority chain: the last assignment wins
    for cond, value in ((nomatch, Flag.REF_CLOSE_OUT_OF_RANGE),
                        (g.flag_far_oob, Flag.REF_FAR_OUT_OF_RANGE),
                        (g.flag_close_oob, Flag.REF_CLOSE_OUT_OF_RANGE),
                        (g.flag_too_short, Flag.REF_EPIPOLAR_TOO_SHORT),
                        (flag_insufficient, Flag.INSUFFICIENT_GRADIENT),
                        (g.flag_key_oob, Flag.KEY_OUT_OF_RANGE),
                        (g.flag_neg_ref, Flag.NEGATIVE_REF_DEPTH)):
        flag = torch.where(cond, int(value), flag)

    prior_flag = check_args_flag(p_inv, p_var, params.min_inv_depth,
                                 params.max_inv_depth)
    flag = torch.where(prior_flag != int(Flag.SUCCESS), prior_flag, flag)
    flag = torch.where(age == 0, int(Flag.NOT_PROCESSED), flag)

    success = flag == int(Flag.SUCCESS)
    if fuse_prior:
        # precision-weighted fusion of the new observation with the prior
        new_inv_depth, variance = fusion(new_inv_depth, p_inv, variance,
                                         p_var)
    out_inv = torch.where(success, new_inv_depth, p_inv)
    out_var = torch.where(success, variance, p_var)
    return safe_invert(out_inv), out_var, flag


# ------------------------------------------------------------- full update

def _per_ref_tuple(value, R_frames):
    """Broadcast an int to a per-refframe tuple; validate tuples."""
    if isinstance(value, int):
        return (value,) * R_frames
    value = tuple(value)
    if len(value) != R_frames:
        raise ValueError(f"{len(value)} per-refframe values for "
                         f"{R_frames} refframes")
    return value


def update_depth_sweep(keyframe, refframes, age_map, prior_depth,
                       prior_variance, params, n_planes=DEFAULT_N_PLANES,
                       redirect=None, col_offset=None, fuse_prior=False):
    """Full-map inverse-depth update via plane sweep.

    keyframe + stacked refframe history (oldest first); each pixel's age
    selects refframe R - age, reassigned through ``redirect`` (a tuple of
    refframe indices, one per refframe).  ``n_planes`` is an int or a
    per-refframe tuple.  Returns (depth_map, variance_map, flag_map).

    ``col_offset`` (an int) switches to the column-block mode of the
    column-sharded update (``parallel/sharded_semi_dense.py``):
    ``age_map`` and ``prior_*`` are the (H, w) block of the map's columns
    col_offset .. col_offset+w-1, and the key and ref images stay whole.
    The Sobel gradients are taken on the whole key image and then cut (a
    Sobel of the block alone would pad its inner edges with zeros), and
    the key patch and plane warps are computed at the block's pixels
    only, sampling the whole images.  Each pixel's arithmetic is that of
    the whole-map update, so the block equals its columns of it.
    """
    H, W = prior_depth.shape
    R_frames = refframes.image.shape[0]
    f32 = keyframe.image.dtype
    device = keyframe.image.device
    N = H * W
    S_all = _per_ref_tuple(n_planes, R_frames)
    if redirect is None:
        redirect = tuple(range(R_frames))
    redirect = _per_ref_tuple(redirect, R_frames)

    T_wk = keyframe.transform_wf
    T_rk_all = matmul_small(inv_motion_matrix(refframes.transform_wf), T_wk)
    e_key_all = {r: calc_key_epipole(T_wk, refframes.transform_wf[r])
                 for r in set(redirect)}

    cols = None if col_offset is None else (int(col_offset), W)
    col0 = 0 if cols is None else cols[0]
    gx = sobel_x(keyframe.image)[:, col0:col0 + W]
    gy = sobel_y(keyframe.image)[:, col0:col0 + W]
    Y, X = torch.meshgrid(torch.arange(H, dtype=f32, device=device),
                          torch.arange(col0, col0 + W, dtype=f32,
                                       device=device),
                          indexing="ij")
    us_x, us_y = X.ravel(), Y.ravel()

    age = age_map.ravel().to(torch.int32)
    prior_v = prior_variance.ravel().to(f32)
    prior_inv = safe_invert(prior_depth.ravel().to(f32))
    ridx = torch.clamp(R_frames - age, 0, R_frames - 1).to(torch.int64)
    with sync_point("sync.sweep.redirect"):
        redirect_t = torch.tensor(redirect, dtype=torch.int64, device=device)
    ridx = redirect_t[ridx]
    active = sorted(set(redirect))

    key_shape = tuple(keyframe.image.shape)
    ref_shape = tuple(refframes.image.shape[1:])

    def select_active(*per_ref):
        """Merge per-active-refframe arrays by each pixel's refframe."""
        out = per_ref[0]
        for i in range(1, len(active)):
            out = torch.where(ridx == active[i], per_ref[i], out)
        return out

    # per-pixel geometry and failure flags, per active refframe
    geos = [
        pixel_geometry_map(
            us_x, us_y, prior_inv, prior_v, T_rk_all[r], e_key_all[r],
            keyframe.focal_length, keyframe.offset, key_shape,
            refframes.focal_length[r], refframes.offset[r], ref_shape,
            params, S_all[r])
        for r in active]
    geo = type(geos[0])(*(select_active(*fields) for fields in zip(*geos)))

    # plane grids, uniform in inverse depth over the valid global range
    q0 = params.min_inv_depth
    q1 = params.max_inv_depth
    lo, hi = clamped_range(prior_inv, prior_v, q0, q1)
    half_w = N_KEY_SAMPLES // 2

    def arc_step_map(T, n):
        """Per-pixel epipolar arc length of one plane step of refframe
        T's grid of n planes ([q0, q1] spans n - 2*half_w - 1 steps)."""
        R = get_rotation(T)
        t = get_translation(T)
        r0 = R[0, 0] * geo.x_key_x + R[0, 1] * geo.x_key_y + R[0, 2]
        r1 = R[1, 0] * geo.x_key_x + R[1, 1] * geo.x_key_y + R[1, 2]
        r2 = R[2, 0] * geo.x_key_x + R[2, 1] * geo.x_key_y + R[2, 2]

        def warp_xy(depth):
            z = depth * r2 + t[2]
            return ((depth * r0 + t[0]) / (z + EPSILON),
                    (depth * r1 + t[1]) / (z + EPSILON))

        xa_x, xa_y = warp_xy(safe_invert(q1))
        xb_x, xb_y = warp_xy(safe_invert(q0))
        dx = xb_x - xa_x
        dy = xb_y - xa_y
        return sqrt(dx * dx + dy * dy) / as_divisor(
            n - 2 * half_w - 1, dx)

    step_sweep = select_active(*[arc_step_map(T_rk_all[r], S_all[r])
                                 for r in active])
    ratio = geo.key_step_size / (geo.step + EPSILON)
    key_step_sweep = ratio * step_sweep

    # key patch along the epipolar direction; the plane axis runs in
    # increasing q, opposite to the scattered path's sample order
    K_stack = _key_patch_stack(
        keyframe.image, keyframe.focal_length, key_step_sweep.reshape(H, W),
        -geo.key_dir_x.reshape(H, W), -geo.key_dir_y.reshape(H, W),
        cols=cols)
    dK = torch.diff(K_stack, dim=0)
    key_grad_map = sqrt(dK[0] * dK[0] + dK[1] * dK[1] + dK[2] * dK[2]
                              + dK[3] * dK[3])

    # gradient gate at the reference-equivalent template spacing
    gate_scale = geo.key_step_size / (key_step_sweep + EPSILON)
    kgrad_post = key_grad_map.ravel() * gate_scale
    ks_post = geo.key_step_size

    # per-refframe plane stacks merged into ONE volume by each pixel's
    # refframe, then a single SSD search with per-pixel window bounds
    ridx_map = ridx.reshape(H, W)
    S_max = max(S_all[r] for r in active)
    V_sel = torch.full((S_max, H, W), -1.0, dtype=f32, device=device)
    dq_sel = torch.zeros((N,), dtype=f32, device=device)
    for r in active:
        S_r = S_all[r]
        dq = (q1 - q0) / as_divisor(S_r - 2 * half_w - 1, q0)
        qs = q0 + dq * (torch.arange(S_r, dtype=f32, device=device) - half_w)
        qs = torch.clamp(qs, min=EPSILON)
        V = warp_plane_stack(refframes.image[r], T_rk_all[r], qs,
                             keyframe.focal_length, keyframe.offset,
                             refframes.focal_length[r], refframes.offset[r],
                             cols=cols)
        if S_r < S_max:
            V = F.pad(V, (0, 0, 0, 0, 0, S_max - S_r), value=-1.0)
        V_sel = torch.where(ridx_map[None] == r, V, V_sel)
        dq_sel = torch.where(ridx == r, dq, dq_sel)

    dq_sel = dq_sel.reshape(H, W)
    tol = 0.5 * dq_sel
    mlo = torch.ceil((lo.reshape(H, W) - tol - q0) / dq_sel)
    mhi = torch.floor((hi.reshape(H, W) + tol - q0) / dq_sel)
    bm, ec, ep, en = ssd_search(V_sel, K_stack, mlo, mhi)

    # parabolic subpixel refinement in inverse-depth units
    denom = ep - 2.0 * ec + en
    ok = (ep < _INF) & (en < _INF) & (torch.abs(denom) > EPSILON)
    delta = torch.where(
        ok, torch.clamp(0.5 * (ep - en) / torch.where(ok, denom, 1.0),
                        -0.5, 0.5), 0.0)
    q_star_map = q0 + (bm.to(f32) + delta) * dq_sel
    q_star = torch.clamp(q_star_map.ravel(), lo, hi)
    no_match = (bm < 0).ravel()

    posts = [
        postprocess_map(q_star, no_match, kgrad_post, ks_post, gx.ravel(),
                        gy.ravel(), geo, prior_inv, prior_v, T_rk_all[r],
                        age, params=params, fuse_prior=fuse_prior)
        for r in active]
    depth, variance, flags = (select_active(*[p[i] for p in posts])
                              for i in range(3))
    return (depth.reshape(H, W), variance.reshape(H, W),
            flags.reshape(H, W))
