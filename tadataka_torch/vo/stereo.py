"""Rectified-stereo block matching and depth (counterpart of
``tadataka_tpu/vo/stereo.py``).

``match_stereo`` scores every disparity d in [0, max_disparity) at
every pixel by the SSD of a (2r+1)^2 block, the right image shifted by d
columns with wrap, takes the argmin with a sub-pixel parabola fit, and
keeps pixels that pass a left-right check, a texture gate and the range
test.  The JAX module's box filter is a difference of cumulative sums;
a cumulative sum scans in another order on the card than on the CPU, so
here the (2r+1) shifted taps are summed in one fixed order instead: rows
first, then columns, each left to right over a zero-padded image.  The
filter computes the same moving sum, and its bits are the same on every
device.  Each cost volume (max_disparity x H x W float32, 157 MB at
480x640 and 128 disparities) is built one direction at a time and freed
before the next.
"""

import torch
import torch.nn.functional as F

from tadataka_torch.device import resolve_device

BIG = 1e9


def _box_filter(x, radius):
    """Moving (2r+1)^2 sum over the last two axes, zero outside: the
    taps summed rows first, then columns, each from the lowest offset up."""
    k = 2 * radius + 1
    H, W = x.shape[-2:]
    padded = F.pad(x, (0, 0, radius, radius))
    rows = padded[..., 0:H, :]
    for i in range(1, k):
        rows = rows + padded[..., i:i + H, :]
    padded = F.pad(rows, (radius, radius))
    out = padded[..., 0:W]
    for i in range(1, k):
        out = out + padded[..., i:i + W]
    return out


def _shifted(image, shifts):
    """(D, H, W): ``image`` rolled along its columns by each shift, as
    ``roll(image, d, axis=1)`` is (column x reads x - d, with wrap)."""
    W = image.shape[1]
    xs = torch.arange(W, device=image.device)
    cols = torch.remainder(xs[None, :] - shifts[:, None], W)     # (D, W)
    return image[:, cols].permute(1, 0, 2)


def _cost_volume(image_a, image_b, shifts, radius, invalid):
    """Box-filtered squared differences of ``image_a`` against
    ``image_b`` rolled by each shift, BIG where ``invalid`` (D, W) holds.
    The penalty goes on after the filter, as in the JAX module."""
    diff = image_a[None] - _shifted(image_b, shifts)
    cost = _box_filter(diff * diff, radius)
    return torch.where(invalid[:, None, :], BIG, cost)


def match_stereo(image_l, image_r, max_disparity=96, radius=3):
    """SSD block matching with sub-pixel refinement and a left-right
    check on a rectified pair (the right match of left pixel x sits at
    x - disparity).  ``image_l``, ``image_r``: (H, W) float32 tensors on
    one device.  Returns (disparity (H, W) float32, valid (H, W) bool)."""
    H, W = image_l.shape
    device = image_l.device
    f32 = image_l.dtype
    xs = torch.arange(W, device=device)
    ds = torch.arange(max_disparity, device=device)

    # left view: right image sampled at x - d; windows reaching x - d < 0
    # are penalized
    costs = _cost_volume(image_l, image_r, ds, radius,
                         xs[None, :] - radius < ds[:, None])
    disp = torch.argmin(costs, dim=0)                  # first index on ties

    # sub-pixel parabola through the winner's neighbours
    d0 = torch.clamp(disp, 1, max_disparity - 2)
    c_m, c_0, c_p = (torch.gather(costs, 0, (d0 + off)[None])[0]
                     for off in (-1, 0, 1))
    del costs
    denom = c_m - 2.0 * c_0 + c_p
    delta = torch.where(torch.abs(denom) > 1e-12,
                        0.5 * (c_m - c_p) / torch.where(denom == 0, 1.0,
                                                        denom),
                        0.0)
    disp_sub = d0.to(f32) + torch.clamp(delta, -1.0, 1.0)

    # right view, for the left-right check: left image at x + d
    costs_r = _cost_volume(image_r, image_l, -ds, radius,
                           xs[None, :] + radius + ds[:, None] > W - 1)
    disp_r = torch.argmin(costs_r, dim=0)
    del costs_r

    # disp_r at (x - disp(x)) should equal disp(x)
    x_r = torch.clamp(xs[None, :] - disp, 0, W - 1)
    disp_r_at = torch.gather(disp_r, 1, x_r)
    lr_ok = torch.abs(disp_r_at - disp) <= 1

    # texture gate: flat blocks match everywhere
    grad_x = torch.abs(torch.diff(image_l, dim=1, prepend=image_l[:, :1]))
    textured = (_box_filter(grad_x, radius)
                > 0.5 * (2 * radius + 1) ** 2 * 0.01)

    in_range = ((disp > 0) & (disp < max_disparity - 1)
                & (xs[None, :] >= max_disparity))
    return disp_sub, lr_ok & textured & in_range


def depth_from_disparity(disparity, focal_length_x, baseline):
    """depth = f_x * B / disparity (rectified pinhole stereo)."""
    return focal_length_x * baseline / torch.clamp(disparity, min=1e-6)


def estimate_depth_from_stereo(camera_params, image_l, image_r, baseline,
                               max_disparity=96, radius=3, device="cuda"):
    """(depth_map, valid_mask) of a rectified pair, on ``device`` (the
    card unless the caller asks for the CPU; raises if it names CUDA and
    there is none).  The images are (H, W) arrays or tensors, taken as
    float32."""
    device = resolve_device(device)
    as_f32 = lambda im: torch.as_tensor(im).to(device=device,
                                               dtype=torch.float32)
    disp, valid = match_stereo(as_f32(image_l), as_f32(image_r),
                               max_disparity=max_disparity, radius=radius)
    fx = camera_params.focal_length[0].to(device=device,
                                          dtype=torch.float32)
    return depth_from_disparity(disp, fx, baseline), valid
