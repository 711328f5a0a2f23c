"""Depth/variance map propagation to the next frame (counterpart of
``tadataka_tpu/vo/semi_dense/propagation.py::propagate``).

Every pixel's hypothesis is warped into the next frame, its variance
inflated by the inverse-depth ratio to the 4th power plus a bias.
Collisions resolve deterministically: (1) a scatter-min on depth elects
the nearest hypothesis per target cell, with a second scatter-min taking
the smallest variance among the lanes at that depth; (2) every
hypothesis compatible with its cell's winner joins a precision-weighted
fusion via scatter-add.  The scatter-add sums each cell's terms in
source order on both devices (:func:`scatter_add`), so the card repeats
itself and matches the CPU bit for bit.
"""

import torch

from tadataka_torch.core.coordinates import image_coordinates
from tadataka_torch.core.warp import warp2d
from tadataka_torch.vo.semi_dense.age import target_cells
from tadataka_torch.vo.semi_dense.fusion import are_statistically_same
from tadataka_torch.vo.semi_dense.estimator import safe_invert
from tadataka_torch.utils.timing import sync_point


def scatter_add(n, index, values):
    """(n,) sums of ``values`` into cells ``index``, each cell's terms
    added in source order: a serial ``index_add`` on the CPU, the stable
    sort-based ``index_put_(accumulate=True)`` on the card (an atomic
    ``index_add`` there would add in arrival order)."""
    out = torch.zeros((n,), dtype=values.dtype, device=values.device)
    if values.device.type == "cpu":
        return out.index_add_(0, index, values)
    return out.index_put_((index,), values, accumulate=True)


def propagate_variance(depth0, depth1, variance0, uncertainty_bias):
    """(inv_d1 / inv_d0)^4 * var0 + bias."""
    ratio = safe_invert(depth1) / safe_invert(depth0)
    ratio2 = ratio * ratio               # x**4 as XLA's integer_pow does
    return ratio2 * ratio2 * variance0 + uncertainty_bias


def propagate(T10, camera_params0, camera_params1, depth_map0, variance_map0,
              default_depth, default_variance, uncertainty_bias):
    """Warp (depth, variance) maps from frame 0 into frame 1.
    Returns (depth_map1, variance_map1)."""
    H, W = depth_map0.shape
    f32 = depth_map0.dtype
    device = depth_map0.device
    N = H * W

    us0 = image_coordinates((H, W), dtype=f32, device=device)
    us1, depths1 = warp2d(T10, camera_params0, camera_params1, us0,
                          depth_map0.ravel())
    cell, in_image = target_cells(us1, (H, W))
    valid = in_image & (depths1 > 0)

    variance1 = propagate_variance(depth_map0.ravel(), depths1,
                                   variance_map0.ravel(), uncertainty_bias)
    inf = torch.full((N,), float("inf"), dtype=f32, device=device)

    # pass 1: nearest-depth winner per cell, then its (smallest) variance
    src_depth = torch.where(valid, depths1, inf)
    win_depth = inf.scatter_reduce(0, cell, src_depth, "amin",
                                   include_self=True)
    win_depth_src = win_depth[cell]
    is_winner = valid & (depths1 == win_depth_src)
    win_var = inf.scatter_reduce(0, cell, torch.where(is_winner, variance1,
                                                      inf),
                                 "amin", include_self=True)[cell]

    # pass 2: precision-weighted fusion of every hypothesis compatible
    # with its cell's winner, in inverse-depth space
    inv_d = safe_invert(depths1)
    compat = valid & are_statistically_same(
        inv_d, safe_invert(win_depth_src), variance1, win_var)
    w = torch.where(compat, 1.0 / torch.clamp(variance1, min=1e-12), 0.0)
    sum_w = scatter_add(N, cell, w)
    sum_mu = scatter_add(N, cell, w * inv_d)

    occupied = torch.isfinite(win_depth) & (sum_w > 0)
    fused_inv = sum_mu / torch.clamp(sum_w, min=1e-12)
    fused_var = 1.0 / torch.clamp(sum_w, min=1e-12)
    with sync_point("sync.propagation.defaults", 2):
        default_d = torch.as_tensor(default_depth, dtype=f32, device=device)
        default_v = torch.as_tensor(default_variance, dtype=f32,
                                    device=device)
    depth1 = torch.where(occupied, safe_invert(fused_inv), default_d)
    variance1 = torch.where(occupied, fused_var, default_v)
    return depth1.reshape(H, W), variance1.reshape(H, W)
