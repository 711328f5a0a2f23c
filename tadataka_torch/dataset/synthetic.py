"""Synthetic textured-plane scenes with exact ground truth (counterpart of
``render_plane_scene``, ``multi_plane_scene``, ``export_tum_scene`` and
``export_euroc_scene`` in ``tadataka_tpu/dataset/synthetic.py``).

For a camera with pose T_wc (camera -> world), the ray [x, y, 1] meets
the plane (origin p0, normal n) at depth s = ((p0 - o_w) . n) / (d_w . n),
which is the pinhole depth; each pixel takes the nearest positive
intersection and the plane's texture at that point.
"""

import math
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from tadataka_torch.camera import CameraModel, CameraParameters, RadTan
from tadataka_torch.core.coordinates import image_coordinates
from tadataka_torch.core.pose import Pose
from tadataka_torch.dataset.base import BaseDataset
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


class PlaneScene(NamedTuple):
    plane_origin: torch.Tensor  # (3,)
    plane_normal: torch.Tensor  # (3,), unit


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


class PlaneSceneDataset(BaseDataset):
    """n-frame synthetic sequence over textured planes, with exact poses
    (camera -> world) and depth maps.  ``poses`` defaults to
    ``orbit_poses(n_frames)``; ``planes`` (a list of (origin, normal)
    pairs) to the one plane (``plane_origin``, ``plane_normal``)."""

    def __init__(self, n_frames=6, image_shape=(120, 160),
                 focal_length=(120.0, 120.0),
                 plane_origin=(0.0, 0.0, 10.0),
                 plane_normal=(0.1, -0.05, -1.0),
                 texture=default_texture, poses=None, planes=None,
                 device="cpu"):
        H, W = image_shape
        self.length = n_frames
        self.image_shape = image_shape
        self.camera_model = CameraModel.create(CameraParameters.create(
            focal_length, (W / 2.0, H / 2.0), device=device))
        self.planes = (planes if planes is not None
                       else [(plane_origin, plane_normal)])
        self.texture = texture
        self.poses = (poses if poses is not None
                      else orbit_poses(n_frames, device=device))
        assert len(self.poses) >= n_frames

    def load(self, index):
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
    return PlaneSceneDataset(n_frames, image_shape, focal_length,
                             poses=poses, planes=MULTI_PLANES, device=device)


def export_tum_scene(root, n_frames=4, which_freiburg=1,
                     image_shape=(480, 640), seed=0):
    """Render a textured plane THROUGH the freiburg camera (its RadTan
    distortion included: ``camera_model.normalize`` runs the Newton
    undistort) and write it to ``root`` in TUM RGB-D format: rgb.txt,
    depth.txt and groundtruth.txt, uint8 RGB PNGs, and uint16 depth PNGs
    at 5000 x the sequence's scale, both quantized by truncation.  The
    trajectory, plane and quantization are the JAX package's, and the
    PNGs are written with the port's codec.  ``seed`` is taken as the
    JAX function takes it, and like it draws nothing: the scene is
    deterministic.  Returns the ground-truth camera -> world Poses."""
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


def _sharp_texture(X, Y):
    """High-frequency texture of the EuRoC export: its rig's field of
    view is narrow, so the default texture is too smooth at the pixel
    scale for corner detection."""
    v = (torch.sin(9.0 * X) * torch.cos(11.0 * Y)
         + 0.6 * torch.sin(23.0 * X + 0.7) * torch.sin(19.0 * Y + 1.1)
         + 0.4 * torch.cos(41.0 * X - 1.9) * torch.cos(37.0 * Y + 0.3)
         + 0.3 * torch.sin(83.0 * X + 2.7) * torch.cos(71.0 * Y - 0.8))
    return 0.5 + 0.2 * v


EUROC_PLANES = [((0.0, 0.0, 2.5), (0.06, -0.04, -1.0)),
                ((-0.5, 0.0, 1.9), (0.5, 0.0, -1.0)),
                ((0.5, 0.3, 2.1), (-0.45, -0.25, -1.0))]


def export_euroc_scene(root, n_frames=5, image_shape=(240, 320),
                       baseline=0.11):
    """Render a textured stereo sequence and write it to ``root`` in
    EuRoC MAV format: cam0 / cam1 with ``sensor.yaml`` (intrinsics,
    RadTan k1 k2 p1 p2, T_BS), ``data.csv`` listings of nanosecond-named
    uint8 PNGs (the port's codec), and the body poses in
    ``state_groundtruth_estimate0/data.csv`` (quaternions w, x, y, z).
    Both cameras share one body -> camera rotation, so the pair stays a
    lateral stereo rig with ``baseline`` along the camera x axis.  The
    ground-truth (image, depth) of every cam0 frame goes to
    ``root/debug_gt/<i>.npz`` (not part of the format).  The rig, the
    three planes, the texture and the trajectory are the JAX package's.
    Returns the body -> world Poses."""
    H, W = image_shape
    root = Path(root)
    focal = (0.7 * W, 0.7 * W)
    offset = (W / 2.0 + 3.0, H / 2.0 - 2.0)
    dist = [-0.08, 0.01, 5e-5, 1e-5]

    R_bc = Rotation.from_rotvec([0.02, -0.03, 0.01]).as_matrix()
    T_bc0 = np.eye(4)
    T_bc0[:3, :3] = R_bc
    T_bc0[:3, 3] = [0.015, -0.01, 0.005]
    T_bc1 = T_bc0.copy()
    T_bc1[:3, 3] = T_bc0[:3, 3] + R_bc @ np.array([baseline, 0.0, 0.0])
    cam_model = CameraModel.create(CameraParameters.create(focal, offset),
                                   RadTan.create(dist))

    def write_cam(idx, T_bc):
        d = root / f"cam{idx}"
        (d / "data").mkdir(parents=True, exist_ok=True)
        (d / "sensor.yaml").write_text(
            "sensor_type: camera\n"
            f"intrinsics: [{focal[0]}, {focal[1]}, {offset[0]}, "
            f"{offset[1]}]\n"
            "distortion_model: radial-tangential\n"
            f"distortion_coefficients: [{dist[0]}, {dist[1]}, {dist[2]}, "
            f"{dist[3]}]\n"
            "T_BS:\n"
            "  rows: 4\n  cols: 4\n"
            "  data: [" + ", ".join(f"{v:.9f}" for v in T_bc.ravel())
            + "]\n")
        return d

    d0 = write_cam(0, T_bc0)
    d1 = write_cam(1, T_bc1)
    gt_dir = root / "debug_gt"
    gt_dir.mkdir(exist_ok=True)
    (root / "state_groundtruth_estimate0").mkdir(exist_ok=True)

    body_poses = [Pose.from_rotvec(
        torch.tensor([0.004 * i, 0.006 * i, 0.002 * i]),
        torch.tensor([0.04 * i, 0.015 * i, 0.01 * i]))
        for i in range(n_frames)]
    rows0, rows1, rows_gt = [], [], []
    for i, pose_wb in enumerate(body_poses):
        ts = 1403636579763555584 + i * 50000000
        T_wb = np.eye(4)
        T_wb[:3, :3] = pose_wb.R.numpy()
        T_wb[:3, 3] = pose_wb.t.numpy()
        for cam_i, (d, T_bc, rows) in enumerate(
                [(d0, T_bc0, rows0), (d1, T_bc1, rows1)]):
            T_wc = T_wb @ T_bc
            pose_wc = Pose(torch.from_numpy(T_wc[:3, :3].astype(np.float32)),
                           torch.from_numpy(T_wc[:3, 3].astype(np.float32)))
            image, depth = render_plane_scene(
                cam_model, pose_wc, image_shape, texture=_sharp_texture,
                planes=EUROC_PLANES)
            u8 = np.clip(image.numpy() * 255.0, 0, 255).astype(np.uint8)
            imsave(d / "data" / f"{ts}.png", u8)
            rows.append(f"{ts},{ts}.png")
            if cam_i == 0:
                np.savez(gt_dir / f"{i}.npz", image=image.numpy(),
                         depth=depth.numpy())
        q = Rotation.from_matrix(T_wb[:3, :3]).as_quat()      # x y z w
        p = T_wb[:3, 3]
        rows_gt.append(f"{ts},{p[0]},{p[1]},{p[2]},{q[3]},{q[0]},{q[1]},"
                       f"{q[2]},0,0,0,0,0,0,0,0,0")
    for d, rows in ((d0, rows0), (d1, rows1)):
        (d / "data.csv").write_text(
            "#timestamp [ns],filename\n" + "\n".join(rows) + "\n")
    (root / "state_groundtruth_estimate0" / "data.csv").write_text(
        "#timestamp,px,py,pz,qw,qx,qy,qz,...\n" + "\n".join(rows_gt)
        + "\n")
    return body_poses
