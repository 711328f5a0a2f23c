"""EuRoC MAV dataset loader (counterpart of
``tadataka_tpu/dataset/euroc.py``): stereo cam0 / cam1 with the
intrinsics, RadTan coefficients and T_BS extrinsics of each
``sensor.yaml`` (read by ``sensor_yaml``, the port's reader of that
subset of YAML), and the body-frame ground truth synchronized to both
image streams.  Frames hold CPU tensors: the uint8 gray image, no depth,
and the camera -> world Pose T_wb @ T_BS."""

from pathlib import Path

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from tadataka_torch.camera import CameraModel, CameraParameters, RadTan
from tadataka_torch.core.pose import Pose
from tadataka_torch.dataset import sensor_yaml
from tadataka_torch.dataset.base import BaseDataset
from tadataka_torch.dataset.frame import Frame
from tadataka_torch.dataset.image_io import imread
from tadataka_torch.dataset.tum import load_image_paths, synchronize


def _camera_dir(dataset_root, camera_index):
    return Path(dataset_root, "cam" + str(camera_index))


def _load_image_paths(dataset_root, camera_index):
    d = _camera_dir(dataset_root, camera_index)
    return load_image_paths(Path(d, "data.csv"), Path(d, "data"),
                            delimiter=",")


def load_camera_params(dataset_root, camera_index):
    """(intrinsics (4,), distortion coefficients, T_BS (4, 4)), float64.
    A number YAML 1.1 leaves a string (``5e-05``) converts here."""
    d = sensor_yaml.load(Path(_camera_dir(dataset_root, camera_index),
                              "sensor.yaml"))
    intrinsics = np.array(d["intrinsics"], dtype=np.float64)
    dist_coeffs = np.array(d["distortion_coefficients"], dtype=np.float64)
    T_bs = np.array(d["T_BS"]["data"], dtype=np.float64).reshape(4, 4)
    return intrinsics, dist_coeffs, T_bs


def load_body_poses(dataset_root):
    """(timestamps, body -> world Rotations, positions) of the ground
    truth; its quaternions are stored w, x, y, z."""
    array = np.loadtxt(Path(dataset_root, "state_groundtruth_estimate0",
                            "data.csv"), delimiter=",", ndmin=2)
    rotations = Rotation.from_quat(array[:, [5, 6, 7, 4]])
    return array[:, 0], rotations, array[:, 1:4]


def _camera_model(intrinsics, dist_coeffs):
    return CameraModel.create(
        CameraParameters.create(intrinsics[0:2], intrinsics[2:4]),
        RadTan.create(dist_coeffs))


class EurocDataset(BaseDataset):
    def __init__(self, dataset_root):
        intrinsics0, dist0, self.T_bc0 = load_camera_params(dataset_root, 0)
        intrinsics1, dist1, self.T_bc1 = load_camera_params(dataset_root, 1)
        self.camera_model0 = _camera_model(intrinsics0, dist0)
        self.camera_model1 = _camera_model(intrinsics1, dist1)

        timestamps0, image_paths0 = _load_image_paths(dataset_root, 0)
        timestamps1, image_paths1 = _load_image_paths(dataset_root, 1)
        timestamps_body, rotations_wb, t_wb = load_body_poses(dataset_root)
        matches = synchronize(timestamps_body, timestamps0,
                              timestamps_ref=timestamps1)
        indices_wb, indices0, indices1 = matches.T
        self.rotations_wb = rotations_wb[indices_wb]
        self.t_wb = t_wb[indices_wb]
        self.image_paths0 = [image_paths0[i] for i in indices0]
        self.image_paths1 = [image_paths1[i] for i in indices1]
        self.length = matches.shape[0]

    def load(self, index):
        T_wb = np.eye(4)
        T_wb[:3, :3] = self.rotations_wb[index].as_matrix()
        T_wb[:3, 3] = self.t_wb[index]
        frames = []
        for T_bc, camera_model, paths in (
                (self.T_bc0, self.camera_model0, self.image_paths0),
                (self.T_bc1, self.camera_model1, self.image_paths1)):
            T_wc = T_wb @ T_bc
            pose = Pose(torch.from_numpy(np.asarray(T_wc[:3, :3],
                                                    np.float32)),
                        torch.from_numpy(np.asarray(T_wc[:3, 3],
                                                    np.float32)))
            frames.append(Frame(camera_model, pose,
                                torch.from_numpy(imread(paths[index])),
                                None))
        return tuple(frames)
