"""Synthetic textured-plane scenes with exact ground truth (counterpart of
``render_plane_scene``, ``multi_plane_scene`` and ``export_tum_scene`` in
``tadataka_tpu/dataset/synthetic.py``).

For a camera with pose T_wc (camera -> world), the ray [x, y, 1] meets
the plane (origin p0, normal n) at depth s = ((p0 - o_w) . n) / (d_w . n),
which is the pinhole depth; each pixel takes the nearest positive
intersection and the plane's texture at that point.
"""

import math
from pathlib import Path

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from tadataka_torch.camera import CameraModel, CameraParameters
from tadataka_torch.core.coordinates import image_coordinates
from tadataka_torch.core.pose import Pose
from tadataka_torch.dataset.frame import Frame
from tadataka_torch.dataset.image_io import imsave
from tadataka_torch.dataset.tum_rgbd import (
    DEPTH_FACTOR, _cfg, get_camera_model_rgb)


def default_texture(X, Y):
    """Smooth, gradient-rich texture on the plane's (X, Y) coordinates."""
    v = (torch.sin(1.3 * X) * torch.cos(1.7 * Y)
         + 0.5 * torch.sin(3.1 * X + 0.7) * torch.sin(2.3 * Y + 1.1)
         + 0.25 * torch.cos(7.3 * X - 1.9) * torch.cos(5.9 * Y + 0.3)
         + 0.125 * torch.sin(13.7 * X + 2.7) * torch.cos(11.1 * Y - 0.8))
    return 0.5 + 0.25 * v


def render_plane_scene(camera_model, pose_wc, image_shape,
                       plane_origin=(0.0, 0.0, 10.0),
                       plane_normal=(0.0, 0.0, -1.0),
                       texture=default_texture, planes=None):
    """Render (image, depth_map) for a camera at pose_wc (camera->world);
    ``planes`` is an optional list of (origin, normal) pairs."""
    if planes is None:
        planes = [(plane_origin, plane_normal)]
    H, W = image_shape
    device = pose_wc.R.device
    f32 = torch.float32
    xs = camera_model.normalize(image_coordinates(image_shape,
                                                  device=device))
    dirs_c = torch.cat([xs, torch.ones_like(xs[:, :1])], dim=-1)
    o_w = pose_wc.t                               # camera centre in world
    d_w = dirs_c @ pose_wc.R.T                    # ray directions in world

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
        # offset texture coordinates per plane so surfaces look distinct
        best_xy = torch.where(closer[:, None], X_w[:, :2] + 3.1 * k, best_xy)
    best_s = torch.where(torch.isinf(best_s), 100.0, best_s)
    image = texture(best_xy[:, 0], best_xy[:, 1]).reshape(H, W)
    return image, best_s.reshape(H, W)


class PlaneSceneDataset:
    """n-frame synthetic sequence over textured planes, with exact poses
    (camera -> world) and depth maps."""

    def __init__(self, poses, image_shape=(120, 160),
                 focal_length=(120.0, 120.0), planes=None,
                 texture=default_texture, device="cpu"):
        H, W = image_shape
        self.image_shape = image_shape
        self.camera_model = CameraModel.create(CameraParameters.create(
            focal_length, (W / 2.0, H / 2.0), device=device))
        self.planes = planes
        self.texture = texture
        self.poses = poses

    def __len__(self):
        return len(self.poses)

    def __getitem__(self, index):
        pose = self.poses[index]
        image, depth = render_plane_scene(
            self.camera_model, pose, self.image_shape, texture=self.texture,
            planes=self.planes)
        return Frame(self.camera_model, pose, image, depth)


MULTI_PLANES = [
    ((0.0, 0.0, 10.0), (0.05, -0.02, -1.0)),
    ((-1.5, 0.0, 7.0), (0.6, 0.0, -1.0)),
    ((1.5, 1.0, 8.0), (-0.5, -0.3, -1.0)),
]


def orbit_poses(n_frames, radius=0.4, z_step=0.05, yaw_step=0.01,
                device="cpu"):
    """A gentle sideways+forward trajectory looking roughly at +z."""
    return [Pose.from_rotvec(
        torch.tensor([0.0, yaw_step * i, 0.0], device=device),
        torch.tensor([radius * math.sin(0.3 * i), 0.02 * i, z_step * i],
                     device=device))
        for i in range(n_frames)]


def multi_plane_scene(n_frames=6, image_shape=(120, 160),
                      focal_length=(120.0, 120.0), poses=None,
                      device="cpu"):
    """Three tilted planes at different depths (non-coplanar)."""
    if poses is None:
        poses = orbit_poses(n_frames, device=device)
    return PlaneSceneDataset(poses[:n_frames], image_shape, focal_length,
                             planes=MULTI_PLANES, device=device)


def export_tum_scene(root, n_frames=4, which_freiburg=1,
                     image_shape=(480, 640)):
    """Render a textured plane THROUGH the freiburg camera (its RadTan
    distortion included: ``camera_model.normalize`` runs the Newton
    undistort) and write it to ``root`` in TUM RGB-D format: rgb.txt,
    depth.txt and groundtruth.txt, uint8 RGB PNGs, and uint16 depth PNGs
    at 5000 x the sequence's scale, both quantized by truncation.  The
    trajectory, plane and quantization are the JAX package's, and the
    PNGs are written with the port's codec.  Returns the ground-truth
    camera -> world Poses."""
    root = Path(root)
    (root / "rgb").mkdir(parents=True, exist_ok=True)
    (root / "depth").mkdir(exist_ok=True)
    depth_factor = DEPTH_FACTOR * _cfg(which_freiburg)["scale"]
    camera_model = get_camera_model_rgb(which_freiburg)

    poses = [Pose.from_rotvec(torch.tensor([0.0, 0.004 * i, 0.001 * i]),
                              torch.tensor([0.03 * i, 0.01 * i, 0.02 * i]))
             for i in range(n_frames)]
    lines_rgb = ["# color images"]
    lines_depth = ["# depth images"]
    lines_gt = ["# ground truth"]
    for i, pose in enumerate(poses):
        image, depth = render_plane_scene(
            camera_model, pose, image_shape, plane_origin=(0.0, 0.0, 2.5),
            plane_normal=(0.06, -0.04, -1.0))
        rgb8 = np.clip(image.numpy() * 255.0, 0, 255).astype(np.uint8)
        rgb8 = np.repeat(rgb8[:, :, None], 3, axis=2)
        dep16 = np.clip(depth.numpy() * depth_factor, 0,
                        65535).astype(np.uint16)
        t = 100.0 + 0.1 * i
        imsave(root / "rgb" / f"{t:.4f}.png", rgb8)
        imsave(root / "depth" / f"{t + 0.01:.4f}.png", dep16)
        lines_rgb.append(f"{t:.4f} rgb/{t:.4f}.png")
        lines_depth.append(f"{t + 0.01:.4f} depth/{t + 0.01:.4f}.png")
        q = Rotation.from_matrix(pose.R.numpy()).as_quat()
        p = pose.t.numpy()
        lines_gt.append(f"{t + 0.005:.4f} {p[0]} {p[1]} {p[2]} "
                        f"{q[0]} {q[1]} {q[2]} {q[3]}")
    (root / "rgb.txt").write_text("\n".join(lines_rgb) + "\n")
    (root / "depth.txt").write_text("\n".join(lines_depth) + "\n")
    (root / "groundtruth.txt").write_text("\n".join(lines_gt) + "\n")
    return poses
