"""Pixel age propagation (counterpart of
``tadataka_tpu/vo/semi_dense/age.py``): warp each pixel into the next
frame and write age + 1 there, as a deterministic scatter-max; unreached
pixels get age 0."""

import torch

from bench_port.reference.port.core.coordinates import image_coordinates
from bench_port.reference.port.core.warp import warp2d


def target_cells(us1, image_shape):
    """Round warped pixel coords (N, 2) to cells: (cell (N,) int64,
    in_image (N,) bool).  Rounding is half-to-even, as jnp.round; the
    range test runs in float, before the integer cast."""
    H, W = image_shape
    tx = torch.round(us1[:, 0])
    ty = torch.round(us1[:, 1])
    in_image = (0 <= tx) & (tx <= W - 1) & (0 <= ty) & (ty <= H - 1)
    tx = torch.clamp(tx, 0, W - 1).to(torch.int64)
    ty = torch.clamp(ty, 0, H - 1).to(torch.int64)
    return ty * W + tx, in_image


def increment_age(age_map0, camera_params0, camera_params1, T10,
                  depth_map0):
    H, W = age_map0.shape
    us0 = image_coordinates((H, W), device=depth_map0.device)
    us1, _ = warp2d(T10, camera_params0, camera_params1, us0,
                    depth_map0.ravel().to(torch.float32))
    cell, valid = target_cells(us1, (H, W))
    ages = torch.where(valid, age_map0.ravel().to(torch.int32) + 1, 0)
    age1 = torch.zeros((H * W,), dtype=torch.int32, device=ages.device)
    age1 = age1.scatter_reduce(0, cell, ages.to(torch.int32), "amax",
                               include_self=True)
    return age1.reshape(H, W)
