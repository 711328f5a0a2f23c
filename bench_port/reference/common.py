"""What the references share: the frames as the apps prepare them from
the host arrays, the gaps that decide ``correct``, and the control's
rounding.

A map gap is the share of pixels, in %, at which two maps disagree: a
float pixel agrees where both are finite and within a relative 1e-5,
or both are the same non-finite value; an integer pixel agrees where
equal.  A pose gap is how far apart two camera -> world poses put the
scene, in mm: the largest distance between the two images of the
points seen at the corners and the centre of the frame at 8 m.  The
control holds every image and map that a stage reads or writes in
bfloat16, the step below the float32 that the configurations state."""

import numpy as np
import torch

REL_TOL = 1e-5
POINT_DEPTH_M = 8.0
LUMA = np.array([0.2125, 0.7154, 0.0721], dtype=np.float32)


def rgb2gray(image):
    """ITU-R 601 luma on the host (a frozen copy of the port's
    ``dataset/image_io.rgb2gray``)."""
    image = np.asarray(image)
    if image.ndim == 2:
        return image.astype(np.float32)
    if image.dtype == np.uint8:
        image = image.astype(np.float32) / 255.0
    return image[..., :3].astype(np.float32) @ LUMA


def bf16(x):
    """A float tensor held in bfloat16; other tensors as they are."""
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x.to(torch.bfloat16).to(x.dtype)
    return x


def map_gap(a, b):
    """% of pixels at which map ``a`` disagrees with the reference's
    ``b``."""
    a = a.to(b.device)
    if a.shape != b.shape:
        return 100.0
    if b.is_floating_point():
        a = a.to(b.dtype)
        fa, fb = torch.isfinite(a), torch.isfinite(b)
        close = fa & fb & ((a - b).abs() <= REL_TOL * b.abs())
        same = ~fa & ~fb & ((torch.isnan(a) & torch.isnan(b)) | (a == b))
        agree = close | same
    else:
        agree = a == b
    return 100.0 * (1.0 - agree.to(torch.float64).mean().item())


def frame_points(config):
    """Homogeneous camera-frame points (5, 4) at the frame's corners and
    centre, POINT_DEPTH_M away."""
    c = config["camera"]
    H, W = config["image_shape"]
    us = [(0, 0), (W - 1, 0), (0, H - 1), (W - 1, H - 1), (W / 2, H / 2)]
    return np.array([[(u - c["cx"]) / c["fx"] * POINT_DEPTH_M,
                      (v - c["cy"]) / c["fy"] * POINT_DEPTH_M,
                      POINT_DEPTH_M, 1.0] for u, v in us])


def pose_gap_mm(T_a, T_b, points):
    """Largest distance, mm, between the points through two camera ->
    world 4x4 poses."""
    d = (np.asarray(T_a, np.float64) - np.asarray(T_b, np.float64)) \
        @ points.T
    return 1e3 * float(np.linalg.norm(d[:3], axis=0).max())


def host_T(R, t):
    T = np.eye(4)
    T[:3, :3] = R.detach().cpu().numpy().astype(np.float64)
    T[:3, 3] = t.detach().cpu().numpy().astype(np.float64)
    return T


class Gaps:
    """The largest gap of each named comparison over the frames."""

    def __init__(self):
        self.pose = {}
        self.maps = {}

    def add_pose(self, frame, value):
        self.pose[frame] = max(self.pose.get(frame, 0.0), value)

    def add_map(self, name, value):
        self.maps[name] = max(self.maps.get(name, 0.0), value)

    def numbers(self, err=None, tag=""):
        pose = max(self.pose.values(), default=0.0)
        maps = max(self.maps.values(), default=0.0)
        if err is not None:
            print(f"[bench_port] {tag}pose gap by frame (mm): " + ", ".join(
                f"{k} {v:.3g}" for k, v in sorted(self.pose.items())),
                file=err, flush=True)
            print(f"[bench_port] {tag}map gaps (% of pixels): " + ", ".join(
                f"{k} {v:.3g}" for k, v in sorted(self.maps.items())),
                file=err, flush=True)
        return pose, maps
