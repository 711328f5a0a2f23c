"""NewTsukuba stereo dataset loader (counterpart of
``tadataka_tpu/dataset/new_tsukuba.py``): stereo pairs, depth ground
truth in OpenCV XML (read with ``xml.etree``) cached as ``.npy`` next to
the data on first load, the PNGs cached the same way (read with the
port's codec), and the camera track in centimetres with its axes flipped
to the camera convention; baseline 10.  Frames hold CPU tensors: the
uint8 RGB image (alpha dropped), the float64 depth map (or None where
the tree has no depth XMLs) and the camera -> world Pose."""

import os
from pathlib import Path
from xml.etree import ElementTree as ET

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from tadataka_torch.camera import CameraModel, CameraParameters
from tadataka_torch.core.pose import Pose
from tadataka_torch.dataset.base import BaseDataset
from tadataka_torch.dataset.frame import Frame
from tadataka_torch.dataset.image_io import imread


def load_depth_xml(path):
    """The (rows, cols) matrix of an OpenCV XML depth file, float64."""
    rows_node, cols_node, _, data_node = ET.parse(path).getroot()[0]
    height, width = int(rows_node.text), int(cols_node.text)
    depth_map = np.array(data_node.text.split(), dtype=np.float64)
    return depth_map.reshape(height, width)


def _generate_cache(src_dir, cache_dir, src_extension, loader):
    for subdir in ("left", "right"):
        os.makedirs(str(Path(cache_dir, subdir)), exist_ok=True)
        for path in sorted(Path(src_dir, subdir).glob("*" + src_extension)):
            filename = path.name.replace(src_extension, ".npy")
            np.save(str(Path(cache_dir, subdir, filename)), loader(path))


def align_coordinate_system(positions, euler_angles):
    """camera_track.txt is x-right / y-up / z-backward; flip to x-right /
    y-down / z-forward (180 degrees about x; negate the y and z
    rotations)."""
    R = Rotation.from_rotvec([np.pi, 0, 0]).as_matrix()
    positions = positions @ R.T
    euler_angles = euler_angles.copy()
    euler_angles[:, 1:3] = -euler_angles[:, 1:3]
    return positions, euler_angles


def load_poses(pose_path):
    poses = np.loadtxt(pose_path, delimiter=",", ndmin=2)   # one row too
    positions, euler_angles = align_coordinate_system(poses[:, 0:3],
                                                      poses[:, 3:6])
    return Rotation.from_euler("xyz", euler_angles, degrees=True), positions


def calc_baseline_offset(rotation, baseline_length):
    return rotation.as_matrix() @ np.array([baseline_length, 0, 0])


class NewTsukubaDataset(BaseDataset):
    BASELINE = 10.0

    def __init__(self, dataset_root, condition="daylight"):
        self.camera_model = CameraModel.create(
            CameraParameters.create([615.0, 615.0], [320.0, 240.0]))
        groundtruth_dir = Path(dataset_root, "groundtruth")
        illumination_dir = Path(dataset_root, "illumination")
        self.rotations, self.positions = load_poses(
            Path(groundtruth_dir, "camera_track.txt"))

        # depth ground truth is optional: public mirrors strip the XMLs
        depth_dir = Path(groundtruth_dir, "depth_maps")
        self.has_depth = (Path(depth_dir, "left").exists()
                          and any(Path(depth_dir, "left").glob("*.xml")))
        depth_cache_dir = Path(groundtruth_dir, "depth_cache")
        if self.has_depth and not depth_cache_dir.exists():
            _generate_cache(depth_dir, depth_cache_dir, ".xml",
                            load_depth_xml)
        self.depth_L_paths = sorted(Path(depth_cache_dir, "left").glob(
            "*.npy"))
        self.depth_R_paths = sorted(Path(depth_cache_dir, "right").glob(
            "*.npy"))

        image_dir = Path(illumination_dir, condition)
        image_cache_dir = Path(illumination_dir, condition + "_cache")
        if not image_cache_dir.exists():
            _generate_cache(image_dir, image_cache_dir, ".png", imread)
        self.image_L_paths = sorted(Path(image_cache_dir, "left").glob(
            "*.npy"))
        self.image_R_paths = sorted(Path(image_cache_dir, "right").glob(
            "*.npy"))

        n = len(self.positions)
        if not len(self.image_L_paths) == len(self.image_R_paths) == n:
            raise ValueError(f"{dataset_root}: {len(self.image_L_paths)} "
                             f"left and {len(self.image_R_paths)} right "
                             f"images for {n} poses")
        if self.has_depth and not (
                len(self.depth_L_paths) == len(self.depth_R_paths) == n):
            raise ValueError(f"{dataset_root}: {len(self.depth_L_paths)} "
                             f"left and {len(self.depth_R_paths)} right "
                             f"depth maps for {n} poses")

    def __len__(self):
        return len(self.positions)

    def load(self, index):
        image_l = np.load(self.image_L_paths[index])[..., :3]
        image_r = np.load(self.image_R_paths[index])[..., :3]
        if self.has_depth:
            depth_l = torch.from_numpy(np.load(self.depth_L_paths[index]))
            depth_r = torch.from_numpy(np.load(self.depth_R_paths[index]))
        else:
            depth_l = depth_r = None
        rotation = self.rotations[index]
        offset = calc_baseline_offset(rotation, self.BASELINE)
        R = torch.from_numpy(np.asarray(rotation.as_matrix(), np.float32))
        center = self.positions[index]
        pose_wl = Pose(R, torch.from_numpy(
            np.asarray(center - offset / 2.0, np.float32)))
        pose_wr = Pose(R.clone(), torch.from_numpy(
            np.asarray(center + offset / 2.0, np.float32)))
        return (Frame(self.camera_model, pose_wl,
                      torch.from_numpy(np.ascontiguousarray(image_l)),
                      depth_l),
                Frame(self.camera_model, pose_wr,
                      torch.from_numpy(np.ascontiguousarray(image_r)),
                      depth_r))
