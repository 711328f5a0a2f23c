"""TUM RGB-D dataset loader (counterpart of
``tadataka_tpu/dataset/tum_rgbd.py``): the freiburg1-3 intrinsics with
their RadTan coefficients, depth = png / (5000 * the sequence's scale),
and the 3-way ground-truth / rgb / depth timestamp sync.  Frames hold
CPU tensors: the uint8 RGB image, the float32 depth in metres and the
camera -> world Pose."""

from pathlib import Path

import numpy as np
import torch

from tadataka_torch.camera import CameraModel, CameraParameters, RadTan
from tadataka_torch.core.pose import Pose
from tadataka_torch.dataset.frame import Frame
from tadataka_torch.dataset.image_io import imread
from tadataka_torch.dataset.tum import (
    load_image_paths, load_tum_poses, synchronize)

DEPTH_FACTOR = 5000.0

# (rgb intrinsics, rgb radtan, depth intrinsics, depth radtan, depth scale)
_FREIBURG = {
    1: dict(rgb_f=[517.3, 516.5], rgb_c=[318.6, 255.3],
            rgb_d=[0.2624, -0.9531, -0.0054, 0.0026, 1.1633],
            depth_f=[591.1, 590.1], depth_c=[331.0, 234.0],
            depth_d=[-0.0410, 0.3286, 0.0087, 0.0051, -0.5643],
            scale=1.035),
    2: dict(rgb_f=[520.9, 521.0], rgb_c=[325.1, 249.7],
            rgb_d=[0.2312, -0.7849, -0.0033, -0.0001, 0.9172],
            depth_f=[580.8, 581.8], depth_c=[308.8, 253.0],
            depth_d=[-0.2297, 1.4766, 0.0005, -0.0075, -3.4194],
            scale=1.031),
    3: dict(rgb_f=[535.4, 539.2], rgb_c=[320.1, 247.6],
            rgb_d=[0, 0, 0, 0, 0],
            depth_f=[567.6, 570.2], depth_c=[324.7, 250.1],
            depth_d=[0, 0, 0, 0, 0],
            scale=1.000),
}


def _cfg(freiburg):
    try:
        return _FREIBURG[freiburg]
    except KeyError:
        raise ValueError(f"No such sequence 'freiburg{freiburg}'") from None


def _camera_model(f, c, d):
    return CameraModel.create(CameraParameters.create(f, c), RadTan.create(d))


def get_camera_model_rgb(freiburg):
    cfg = _cfg(freiburg)
    return _camera_model(cfg["rgb_f"], cfg["rgb_c"], cfg["rgb_d"])


def get_camera_model_depth(freiburg):
    cfg = _cfg(freiburg)
    return _camera_model(cfg["depth_f"], cfg["depth_c"], cfg["depth_d"])


class TumRgbdDataset:
    def __init__(self, dataset_root, which_freiburg):
        cfg = _cfg(which_freiburg)
        self.depth_factor = DEPTH_FACTOR * cfg["scale"]
        self.camera_model = get_camera_model_rgb(which_freiburg)
        self.camera_model_depth = get_camera_model_depth(which_freiburg)

        timestamps_gt, rotations, positions = load_tum_poses(
            Path(dataset_root, "groundtruth.txt"))
        timestamps_rgb, paths_rgb = load_image_paths(
            Path(dataset_root, "rgb.txt"), prefix=dataset_root)
        timestamps_depth, paths_depth = load_image_paths(
            Path(dataset_root, "depth.txt"), prefix=dataset_root)

        matches = synchronize(timestamps_gt, timestamps_rgb,
                              timestamps_ref=timestamps_depth)
        indices_gt, indices_rgb, indices_depth = matches.T
        self.length = matches.shape[0]
        self.timestamps = timestamps_gt[indices_gt]
        self.rotations = rotations[indices_gt]
        self.positions = positions[indices_gt]
        self.paths_rgb = [paths_rgb[i] for i in indices_rgb]
        self.paths_depth = [paths_depth[i] for i in indices_depth]

    def __len__(self):
        return self.length

    def __getitem__(self, index):
        if isinstance(index, slice):
            return [self.load(i) for i in range(*index.indices(len(self)))]
        if index < 0:
            index += len(self)
        if not 0 <= index < len(self):
            raise IndexError(f"frame {index} of {len(self)}")
        return self.load(index)

    def load(self, index):
        image = imread(self.paths_rgb[index])
        depth = imread(self.paths_depth[index]).astype(np.float32)
        depth = depth / self.depth_factor
        pose = Pose(torch.from_numpy(np.asarray(
            self.rotations[index].as_matrix(), dtype=np.float32)),
            torch.from_numpy(np.asarray(self.positions[index],
                                        dtype=np.float32)))
        return Frame(self.camera_model, pose, torch.from_numpy(image),
                     torch.from_numpy(depth))
