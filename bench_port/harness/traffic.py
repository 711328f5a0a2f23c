"""The traffic generator: a closed loop of camera poses over the
three textured planes, rendered on the device once a run and replayed
without end.

A mix (``traffic/<name>.json``) gives the loop: ``leg`` frames out
along ``step`` (metres a frame, camera -> world), ``turn`` frames
across to a leg ``offset`` metres beside the first, the same leg back,
and ``turn`` frames across to the start; a hand-held ``wobble`` turns
the camera about its x and y axes on a circle of ``amplitude_rad``
once every ``period_frames``, so its angular speed is constant (the
period of the loop is a whole number of wobbles, so the loop closes).
No two frames of a period share a pose.  ``--seed`` sets the frame the
replay starts at (one of the first half of the out leg, so the
bootstrap pair always has a leg step's baseline); every seed replays
the same period of frames, in another order.  The texture's phase is
the mix's, the same for every seed, and applies to either texture.

A configuration may name its scene's ``texture``: ``"default"`` (or no
key) for the smooth texture of the TUM cells, ``"sharp"`` for the
high-frequency one that FAST finds corners on through a narrow field of
view (the port's EuRoC export's).

The renderer is a frozen copy of the port's ``render_plane_scene``,
``default_texture`` and ``_sharp_texture``
(``tadataka_torch/dataset/synthetic.py``); rays
come from the reference's camera model, so a RadTan camera renders the
distorted image the sensor delivers.  Images leave as the camera's
driver hands them over: uint8 RGB (H, W, 3) host arrays, and for an
RGB-D configuration the depth in metres quantised as TUM's 16-bit depth
PNGs at ``depth_factor`` (truncated, 0 where out of range).
"""

import json
import math
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from bench_port.reference.port.camera import (
    CameraModel, CameraParameters, NoDistortion, RadTan)
from bench_port.reference.port.core.pose import Pose

TRAFFIC_DIR = Path(__file__).resolve().parent.parent / "traffic"


class HostFrame(NamedTuple):
    """One frame as the driver hands it over: ``image`` uint8 (H, W, 3),
    ``depth_map`` float32 (H, W) metres or None, ``pose`` the true
    camera -> world 4x4 (float64)."""
    image: np.ndarray
    depth_map: np.ndarray
    pose: np.ndarray


class Loop(NamedTuple):
    frames: list        # one period of HostFrames
    start: int          # period index of the replay's first frame
    phase: tuple        # texture phase (x, y), metres on the plane

    def frame(self, k):
        """The k-th frame of the replay."""
        return self.frames[(self.start + k) % len(self.frames)]

    def index(self, k):
        return (self.start + k) % len(self.frames)


def load_mix(name, directory=TRAFFIC_DIR):
    return json.loads((Path(directory) / f"{name}.json").read_text())


def rotvec_matrix(rotvec):
    """Rodrigues' formula in float64."""
    rotvec = np.asarray(rotvec, np.float64)
    theta = np.linalg.norm(rotvec)
    if theta < 1e-15:
        return np.eye(3)
    k = rotvec / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + math.sin(theta) * K + (1 - math.cos(theta)) * K @ K


def loop_positions(mix):
    """Camera positions (P, 3), float64, of one period of the loop."""
    leg, turn = int(mix["leg"]), int(mix["turn"])
    step = np.asarray(mix["step"], np.float64)
    offset = np.asarray(mix["offset"], np.float64)
    out = [i * step for i in range(leg)]
    end = (leg - 1) * step
    across = [end + offset * j / turn for j in range(1, turn + 1)]
    back = [i * step + offset for i in range(leg - 2, -1, -1)]
    home = [offset * (1 - j / turn) for j in range(1, turn)]
    return np.array(out + across + back + home)


def wobble_rotvec(mix, i):
    """The hand-held wobble's rotation vector at frame ``i`` of the
    period: a circle of ``amplitude_rad`` about the camera's x and y
    axes, once every ``period_frames``, starting at the identity."""
    w = mix["wobble"]
    a, phi = float(w["amplitude_rad"]), 2 * math.pi * i / int(
        w["period_frames"])
    return [a * (math.cos(phi) - 1.0), a * math.sin(phi), 0.0]


def loop_poses(mix):
    """Camera -> world 4x4 poses (float64) of one period of the loop."""
    poses = []
    for i, t in enumerate(loop_positions(mix)):
        T = np.eye(4)
        T[:3, :3] = rotvec_matrix(wobble_rotvec(mix, i))
        T[:3, 3] = t
        poses.append(T)
    return poses


def default_texture(X, Y):
    """Smooth, gradient-rich texture on the plane's (X, Y) coordinates."""
    v = (torch.sin(1.3 * X) * torch.cos(1.7 * Y)
         + 0.5 * torch.sin(3.1 * X + 0.7) * torch.sin(2.3 * Y + 1.1)
         + 0.25 * torch.cos(7.3 * X - 1.9) * torch.cos(5.9 * Y + 0.3)
         + 0.125 * torch.sin(13.7 * X + 2.7) * torch.cos(11.1 * Y - 0.8))
    return 0.5 + 0.25 * v


def sharp_texture(X, Y):
    """High-frequency texture: corners at the pixel scale of a narrow
    field of view."""
    v = (torch.sin(9.0 * X) * torch.cos(11.0 * Y)
         + 0.6 * torch.sin(23.0 * X + 0.7) * torch.sin(19.0 * Y + 1.1)
         + 0.4 * torch.cos(41.0 * X - 1.9) * torch.cos(37.0 * Y + 0.3)
         + 0.3 * torch.sin(83.0 * X + 2.7) * torch.cos(71.0 * Y - 0.8))
    return 0.5 + 0.2 * v


TEXTURES = {"default": default_texture, "sharp": sharp_texture}


def texture_of(config):
    """The configuration's texture: its ``texture`` key, "default" where
    it has none."""
    name = config.get("texture", "default")
    if name not in TEXTURES:
        raise KeyError(f"texture {name!r} is none of {sorted(TEXTURES)}")
    return TEXTURES[name]


def camera_model(config, device="cpu"):
    """The configuration's camera as the reference's CameraModel."""
    c = config["camera"]
    params = CameraParameters.create((c["fx"], c["fy"]), (c["cx"], c["cy"]),
                                     device=device)
    dist = c.get("radtan")
    return CameraModel.create(
        params, NoDistortion() if dist is None
        else RadTan.create(dist, device=device))


def pixel_rays(cm, shape, device):
    """Camera-frame ray directions [x, y, 1] of every pixel, (H*W, 3):
    the camera's normalize (for RadTan its Newton undistort), once."""
    H, W = shape
    Y, X = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                          torch.arange(W, dtype=torch.float32, device=device),
                          indexing="ij")
    xs = cm.normalize(torch.stack([X.ravel(), Y.ravel()], dim=-1))
    return torch.cat([xs, torch.ones_like(xs[:, :1])], dim=-1)


def render(rays, pose_wc, shape, planes, phase, texture=default_texture):
    """(image, depth) of the planes seen along ``rays`` from ``pose_wc``
    (camera -> world): each pixel takes the nearest positive
    intersection and ``texture`` there, shifted by ``phase``."""
    H, W = shape
    device = rays.device
    f32 = torch.float32
    o_w = pose_wc.t
    d_w = rays @ pose_wc.R.T
    best_s = torch.full((H * W,), float("inf"), dtype=f32, device=device)
    best_xy = torch.zeros((H * W, 2), dtype=f32, device=device)
    for k, (origin, normal) in enumerate(planes):
        p0 = torch.tensor(origin, dtype=f32, device=device)
        n = torch.tensor(normal, dtype=f32, device=device)
        n = n / torch.linalg.norm(n)
        denom = d_w @ n
        s = ((p0 - o_w) @ n) / torch.where(torch.abs(denom) < 1e-9, 1e-9,
                                           denom)
        s = torch.where(s > 0, s, float("inf"))
        X_w = o_w + s[:, None] * d_w
        closer = s < best_s
        best_s = torch.where(closer, s, best_s)
        best_xy = torch.where(closer[:, None], X_w[:, :2] + 3.1 * k, best_xy)
    best_s = torch.where(torch.isinf(best_s), 100.0, best_s)
    image = texture(best_xy[:, 0] + phase[0],
                    best_xy[:, 1] + phase[1]).reshape(H, W)
    return image, best_s.reshape(H, W)


def draw(seed, mix):
    """The frame of the period a seed's replay starts at."""
    rng = np.random.default_rng(seed)
    return int(rng.integers(0, max(1, int(mix["leg"]) // 2)))


def make_loop(config, mix, seed, device):
    """One period of the loop rendered on ``device`` and kept on the
    host, with the seed's start."""
    start = draw(seed, mix)
    phase = tuple(float(x) for x in mix["texture_phase"])
    shape = tuple(config["image_shape"])
    cm = camera_model(config, device)
    rays = pixel_rays(cm, shape, device)
    planes = [tuple(map(tuple, p)) for p in config["planes"]]
    texture = texture_of(config)
    factor = config.get("depth_factor")
    frames = []
    for T in loop_poses(mix):
        pose = Pose(torch.as_tensor(T[:3, :3], dtype=torch.float32,
                                    device=device),
                    torch.as_tensor(T[:3, 3], dtype=torch.float32,
                                    device=device))
        image, depth = render(rays, pose, shape, planes, phase, texture)
        u8 = torch.clamp(image * 255.0, 0, 255).to(torch.uint8)
        rgb = u8[:, :, None].expand(*shape, 3).contiguous().cpu().numpy()
        depth_map = None
        if factor is not None:
            d16 = torch.clamp(depth * factor, 0, 65535).to(torch.int32)
            depth_map = (d16.to(torch.float32) / factor).cpu().numpy()
        frames.append(HostFrame(rgb, depth_map, T))
    return Loop(frames, start, phase)
