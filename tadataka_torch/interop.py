"""Carry parameters, frames, poses and VO state between numpy and the
port.

Every ``*_from_numpy`` function takes array-likes (anything
``np.asarray`` accepts, such as the fields of the JAX package's objects)
and builds the port's object on ``device``; :func:`to_numpy` goes back.
Float fields become float32 tensors, integer maps int32.
"""

import numpy as np
import torch

from tadataka_torch.apps.semi_dense_vo import SemiDenseVOState
from tadataka_torch.camera import (
    FOV, CameraModel, CameraParameters, NoDistortion, RadTan)
from tadataka_torch.core.pose import Pose
from tadataka_torch.features.detector import Features
from tadataka_torch.features.matching import Matches
from tadataka_torch.vo.semi_dense.frame import SemiDenseFrame
from tadataka_torch.vo.semi_dense.params import SemiDenseParams


def tensor(a, device="cpu", dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def params_from_numpy(fields, device="cpu"):
    """SemiDenseParams from its six fields in order (min_inv_depth,
    max_inv_depth, geo_coeff, photo_coeff, ref_step_size, min_gradient)."""
    return SemiDenseParams(*(tensor(v, device) for v in fields))


def camera_from_numpy(focal_length, offset, device="cpu"):
    return CameraParameters(tensor(focal_length, device),
                            tensor(offset, device))


def camera_model_from_numpy(focal_length, offset, kind="NoDistortion",
                            params=(), device="cpu"):
    """A CameraModel from its intrinsics and its distortion: ``kind``
    "NoDistortion", "FOV" (``params`` = (omega,)) or "RadTan" (``params``
    = the COLMAP coefficients, padded to five) -- the type name and the
    ``params`` of the JAX package's distortion model."""
    camera = camera_from_numpy(focal_length, offset, device)
    params = np.asarray(params, np.float32).ravel()
    if kind == "NoDistortion":
        distortion = NoDistortion()
    elif kind == "FOV":
        distortion = FOV.create(float(params[0]), device=device)
    elif kind == "RadTan":
        distortion = RadTan.create(params, device=device)
    else:
        raise ValueError(f"Unknown distortion model: {kind}")
    return CameraModel.create(camera, distortion)


def frame_from_numpy(focal_length, offset, image, transform_wf,
                     device="cpu"):
    """A SemiDenseFrame, or a stacked history when every field carries a
    leading refframe axis."""
    return SemiDenseFrame(tensor(focal_length, device), tensor(offset, device),
                          tensor(image, device), tensor(transform_wf, device))


def pose_from_numpy(R, t, device="cpu"):
    return Pose(tensor(R, device), tensor(t, device))


def features_from_numpy(keypoints, descriptors, mask, device="cpu"):
    """Features from keypoints (K, 2), +-1 descriptors (K, D) and a
    mask (K,)."""
    return Features(tensor(keypoints, device), tensor(descriptors, device),
                    tensor(mask, device, torch.bool))


def matches_from_numpy(indices, mask, device="cpu"):
    """Matches from index pairs (K, 2) and a mask (K,)."""
    return Matches(tensor(indices, device, torch.int64),
                   tensor(mask, device, torch.bool))


def poses_from_numpy(poses, device="cpu"):
    """A list of Pose from a list of objects with fields R and t (the JAX
    package's poses, world -> camera as its VO keeps them).  Map points
    need no conversion: both packages keep them as host arrays."""
    return [pose_from_numpy(p.R, p.t, device) for p in poses]


def state_from_numpy(pose_R, pose_t, depth_map, variance_map, age_map,
                     flag_map=None, device="cpu"):
    return SemiDenseVOState(
        pose_from_numpy(pose_R, pose_t, device), tensor(depth_map, device),
        tensor(variance_map, device), tensor(age_map, device, torch.int32),
        None if flag_map is None else tensor(flag_map, device, torch.int32))


def keypoint_frame_from_numpy(ids, coords):
    """A VITAMIN-E KeypointFrame (host arrays: int64 ids, float32 [x, y])."""
    from tadataka_torch.vo.vitamin_e import KeypointFrame
    return KeypointFrame(np.asarray(ids, np.int64),
                         np.asarray(coords, np.float32))


def affine_from_numpy(matrix, device="cpu"):
    """An AffineTransform from its (3, 3) matrix."""
    from tadataka_torch.features.flow import AffineTransform
    return AffineTransform(tensor(matrix, device))


def vitamin_e_state_from_numpy(vo, poses_cw, keypoints, features, points,
                               first_obs, tri_gap):
    """Carry a VITAMIN-E VO's state into the port's ``VitaminEVO`` ``vo``
    (VITAMIN-E has no weights; its state is what a frame reads): the
    world -> camera poses (objects with fields R and t), the keypoint
    frames (objects with fields ids and coords), the latest frame's
    detector features (keypoints, descriptors, mask), the points {track
    id: (3,)}, the first observations {track id: (frame, (2,) xy)} and
    the triangulation gaps {track id: frames}.  Returns ``vo``."""
    vo.poses_cw = poses_from_numpy(poses_cw)
    vo.keypoints = [keypoint_frame_from_numpy(k.ids, k.coords)
                    for k in keypoints]
    vo._features = features_from_numpy(*features, device=vo.device)
    vo.points = {int(k): np.asarray(v, np.float32)
                 for k, v in points.items()}
    vo._first_obs = {int(k): (int(j), np.asarray(xy, np.float32))
                     for k, (j, xy) in first_obs.items()}
    vo._tri_gap = {int(k): int(v) for k, v in tri_gap.items()}
    return vo


def to_numpy(obj):
    """Tensors -> numpy arrays, through (named) tuples and lists."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_numpy(x) for x in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_numpy(x) for x in obj)
    return obj
