"""Rectified disparity sweep of the semi-dense depth update (counterpart
of ``tadataka_tpu/vo/semi_dense/sweep_rect.py``).

The planner picks this path for wide lateral baselines.  Each refframe
is rectified against the keyframe (``rectify.py``), so that the sample
at inverse depth q sits at (x - fB v_z q, y) on the rectified grid and
the planes of the sweep are integer column shifts of ONE shifted ref
image (``_shift_stack``); the key patch is five 1-px shifts of the
rectified key image (``_key_template``).  The same SSD window search as
the homography sweep (``sweep.ssd_search``, the CUDA kernel on the card)
finds each pixel's disparity, a parabola refines it, and the matched
inverse depth is warped back to the key grid as a match-weighted
channel.  Depth, variance and flags come from the shared
``sweep.postprocess_map``.

The port's warps are gathers (``core/shiftwarp.py::rot_warp``) with no
displacement budget; the planner's budget only decides the plan.
"""

import torch
import torch.nn.functional as F

from tadataka_torch.core.gradients import sobel_x, sobel_y, np_gradient_2d
from tadataka_torch.core.rounding import matmul_small
from tadataka_torch.core.shiftwarp import rot_warp, const_shift_cols
from tadataka_torch.core.transforms import inv_motion_matrix
from tadataka_torch.vo.semi_dense.estimator import (
    EPSILON, safe_invert, pixel_geometry_map, calc_key_epipole)
from tadataka_torch.vo.semi_dense.hypothesis import clamped_range
from tadataka_torch.vo.semi_dense.params import N_KEY_SAMPLES
from tadataka_torch.vo.semi_dense.rectify import make_rectification
from tadataka_torch.vo.semi_dense.sweep import (
    ssd_search, postprocess_map, _INF)

DEFAULT_N_PLANES = 64
_PLANE_TOL = 0.5      # half-plane window slack, as in sweep.py


def _flip_x(x):
    return torch.flip(x, dims=(-1,))


def _shift_stack(base, n, fill):
    """(n, H, W) stack: out[j, :, x] = base[:, x - j] (constant fill)."""
    W = base.shape[-1]
    padded = F.pad(base, (n, 0), value=fill)
    return torch.stack([padded[:, n - j:n - j + W] for j in range(n)])


def _key_template(key_rect, fill=-1.0):
    """(5, H, W) template: K[i, :, x] = key_rect[:, x - (i - 2)]."""
    W = key_rect.shape[-1]
    half = N_KEY_SAMPLES // 2
    padded = F.pad(key_rect, (half, half), value=fill)
    return torch.stack([padded[:, half - k:half - k + W]
                        for k in range(-half, half + 1)])


def update_depth_rect(keyframe, refframes, age_map, prior_depth,
                      prior_variance, params, n_planes=DEFAULT_N_PLANES,
                      flips=(False,), fuse_prior=False):
    """Full-map inverse-depth update via the rectified disparity sweep.

    keyframe + stacked refframe history (oldest first); each pixel's age
    selects refframe R - age.  ``flips`` is the per-refframe baseline
    sign from the host planner (``fast.plan_update_np``).  Returns
    (depth_map, variance_map, flag_map).
    """
    H, W = prior_depth.shape
    R_frames = refframes.image.shape[0]
    f32 = keyframe.image.dtype
    device = keyframe.image.device
    if len(flips) != R_frames:
        raise ValueError(f"{len(flips)} flips for {R_frames} refframes")

    T_wk = keyframe.transform_wf
    T_rk_all = matmul_small(inv_motion_matrix(refframes.transform_wf), T_wk)

    gx = sobel_x(keyframe.image)
    gy = sobel_y(keyframe.image)
    Y, X = torch.meshgrid(torch.arange(H, dtype=f32, device=device),
                          torch.arange(W, dtype=f32, device=device),
                          indexing="ij")
    us_x, us_y = X.ravel(), Y.ravel()

    age = age_map.ravel().to(torch.int32)
    prior_v = prior_variance.ravel().to(f32)
    prior_inv = safe_invert(prior_depth.ravel().to(f32))
    ridx = torch.clamp(R_frames - age, 0, R_frames - 1)
    ridx_map = ridx.reshape(H, W)

    def select_ref(*per_ref):
        """Merge per-refframe arrays by each pixel's refframe."""
        out = per_ref[0]
        for i in range(1, R_frames):
            out = torch.where(ridx == i, per_ref[i], out)
        return out

    key_shape = tuple(keyframe.image.shape)
    ref_shape = tuple(refframes.image.shape[1:])
    geos = [
        pixel_geometry_map(
            us_x, us_y, prior_inv, prior_v, T_rk_all[r],
            calc_key_epipole(T_wk, refframes.transform_wf[r]),
            keyframe.focal_length, keyframe.offset, key_shape,
            refframes.focal_length[r], refframes.offset[r], ref_shape,
            params, n_planes)
        for r in range(R_frames)]
    geo = type(geos[0])(*(select_ref(*fields) for fields in zip(*geos)))

    # +-2 sigma inverse-depth bounds on the key grid
    lo, hi = clamped_range(prior_inv, prior_v, params.min_inv_depth,
                           params.max_inv_depth)
    lo_map = lo.reshape(H, W)
    hi_map = hi.reshape(H, W)
    half = N_KEY_SAMPLES // 2
    xs_n = (torch.arange(W, dtype=f32, device=device)[None, :]
            - keyframe.offset[0]) / keyframe.focal_length[0]
    ys_n = (torch.arange(H, dtype=f32, device=device)[:, None]
            - keyframe.offset[1]) / keyframe.focal_length[1]

    q_star_map = torch.zeros((H, W), dtype=f32, device=device)
    nomatch_map = torch.ones((H, W), dtype=torch.bool, device=device)
    for r in range(R_frames):
        rect = make_rectification(
            T_rk_all[r], keyframe.focal_length, keyframe.offset,
            refframes.focal_length[r], refframes.offset[r], flips[r])
        key_rect_b, key_valid = rot_warp(
            torch.stack([keyframe.image, lo_map, hi_map]), rect.H_key_inv)
        ref_rect, _ = rot_warp(refframes.image[r], rect.H_ref_inv)
        # v_z = Z_key / Z_rect on the unflipped rectified grid:
        # disparity(q) = fB * v_z * q
        vz = rect.vz[0] * xs_n + rect.vz[1] * ys_n + rect.vz[2]
        if flips[r]:
            key_rect_b, key_valid, ref_rect, vz = (
                _flip_x(x) for x in (key_rect_b, key_valid, ref_rect, vz))
        key_rect, lo_r, hi_r = key_rect_b

        # disparity planes delta0 + j, starting half_w planes below the
        # smallest valid disparity so the five-plane window exists for
        # priors at the far end
        delta0 = rect.fB * params.min_inv_depth * torch.min(vz) - half
        base = const_shift_cols(ref_rect, -delta0, fill=-1.0)
        V = _shift_stack(base, n_planes, fill=-1.0)            # (S, H, W)
        K = _key_template(key_rect)                            # (5, H, W)

        # per-pixel disparity window -> window-index bounds
        fB_eff = rect.fB * vz
        mlo = torch.ceil(fB_eff * lo_r - delta0 - _PLANE_TOL) - half
        mhi = torch.floor(fB_eff * hi_r - delta0 + _PLANE_TOL) - half
        key_ok = key_valid & torch.all(K >= 0.0, dim=0)
        mlo = torch.where(key_ok, mlo, 1e9)
        mhi = torch.where(key_ok, mhi, -1e9)
        bm, ec, ep, en = ssd_search(V, K, mlo, mhi)
        del V

        # parabolic subpixel refinement in disparity units
        denom = ep - 2.0 * ec + en
        ok = (ep < _INF) & (en < _INF) & (torch.abs(denom) > EPSILON)
        delta = torch.where(
            ok, torch.clamp(0.5 * (ep - en) / torch.where(ok, denom, 1.0),
                            -0.5, 0.5), 0.0)
        d_star = delta0 + bm.to(f32) + half + delta
        q_rect = d_star / (fB_eff + EPSILON)

        # back to the key grid: the disparity rides as a match-weighted
        # channel beside its weight, so no-match lanes drop out of the
        # interpolation instead of blending their placeholder in
        w_rect = (bm >= 0).to(f32)
        out_batch = torch.stack([q_rect * w_rect, w_rect])
        if flips[r]:
            out_batch = _flip_x(out_batch)
        out_key, out_valid = rot_warp(out_batch, rect.H_key)
        w_key = out_key[1]
        q_r = out_key[0] / torch.clamp(w_key, min=1e-6)
        nm_r = (w_key < 0.5) | ~out_valid

        sel = ridx_map == r
        q_star_map = torch.where(sel, q_r, q_star_map)
        nomatch_map = torch.where(sel, nm_r, nomatch_map)

    q_star = torch.clamp(q_star_map.ravel(), lo, hi)
    no_match = nomatch_map.ravel()

    # gradient gate at the reference's support, on the original key
    # image: 2 |dI/dpx . p| with p the per-sample pixel step
    gcx, gcy = np_gradient_2d(keyframe.image)
    px = geo.key_step_size * geo.key_dir_x * keyframe.focal_length[0]
    py = geo.key_step_size * geo.key_dir_y * keyframe.focal_length[1]
    kgrad_post = 2.0 * torch.abs(gcx.ravel() * px + gcy.ravel() * py)

    posts = [
        postprocess_map(q_star, no_match, kgrad_post, geo.key_step_size,
                        gx.ravel(), gy.ravel(), geo, prior_inv, prior_v,
                        T_rk_all[r], age, params=params,
                        fuse_prior=fuse_prior)
        for r in range(R_frames)]
    depth, variance, flags = (select_ref(*[p[i] for p in posts])
                              for i in range(3))
    return (depth.reshape(H, W), variance.reshape(H, W),
            flags.reshape(H, W))
