"""Bundle-adjustment entry points of the feature-based VO (counterpart of
``tadataka_tpu/ba/api.py``).  Poses go to rotation vectors and back
through scipy's ``Rotation`` on the host, as in the JAX package; the LM
solve runs on ``device``.  The JAX package pads observations, points and
poses to power-of-two capacities with zero-weight rows, so that its
compiled program is reused; the port runs at the true counts (a padded
row carries no weight and changes nothing)."""

import warnings

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from tadataka_torch.ba.schur import lm_solve
from tadataka_torch.core.pose import Pose
from tadataka_torch.device import resolve_device, upload


def can_run_ba(n_viewpoints, n_points, n_visible,
               n_pose_params=6, n_point_params=3):
    """Gauge condition: at least as many residual rows as unknowns."""
    n_rows = 2 * n_visible
    n_cols = n_pose_params * n_viewpoints + n_point_params * n_points
    return n_rows >= n_cols


def test_unique(viewpoint_indices, point_indices):
    A = np.vstack((viewpoint_indices, point_indices))
    assert np.unique(A, axis=1).shape[1] == A.shape[1]


def host(x):
    """A tensor or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def run_ba(viewpoint_indices, point_indices, poses, points, keypoints_true,
           max_iter=5, relative_error_threshold=0.20, device="cuda"):
    """Optimize a window of poses (world -> camera Pose objects) and 3D
    points (N, 3) observed at ``keypoints_true`` (O, 2): at most 5 LM
    iterations with a loose relative threshold, a refinement inside the
    VO loop.  Returns (poses as Pose of float32 CPU tensors, points as a
    float32 numpy array)."""
    device = resolve_device(device)
    Rs = np.stack([host(p.R) for p in poses])
    ts = np.stack([host(p.t) for p in poses])
    pose_params = np.concatenate(
        [Rotation.from_matrix(Rs).as_rotvec(), ts], axis=-1).astype(
            np.float32)

    def up(x, dtype):
        return upload(np.asarray(x), device, dtype)

    new_params, new_points, _ = lm_solve(
        up(pose_params, torch.float32), up(points, torch.float32),
        up(viewpoint_indices, torch.int64), up(point_indices, torch.int64),
        up(keypoints_true, torch.float32), max_iter=max_iter,
        absolute_error_threshold=1e-9,
        relative_error_threshold=relative_error_threshold)
    # one read for both outputs; the exponential map on the host
    flat = torch.cat([new_params.reshape(-1),
                      new_points.reshape(-1)]).cpu().numpy()
    new_params = flat[:new_params.numel()].reshape(-1, 6)
    new_points = flat[new_params.size:].reshape(-1, 3)
    new_poses = [Pose(torch.from_numpy(Rotation.from_rotvec(
        new_params[j, :3]).as_matrix().astype(np.float32)),
        torch.from_numpy(new_params[j, 3:].copy()))
        for j in range(len(poses))]
    return new_poses, new_points


def try_run_ba(viewpoint_indices, point_indices, poses, points,
               keypoints_true, device="cuda"):
    """``run_ba`` behind its guards: the indices must name every pose and
    point once at least, each (viewpoint, point) pair once; with fewer
    residual rows than unknowns the inputs come back unchanged, with a
    warning."""
    assert len(viewpoint_indices) == len(point_indices)
    assert len(set(int(v) for v in viewpoint_indices)) == len(poses)
    assert len(set(int(v) for v in point_indices)) == len(points)
    test_unique(viewpoint_indices, point_indices)

    if not can_run_ba(n_viewpoints=len(poses), n_points=len(points),
                      n_visible=len(keypoints_true)):
        warnings.warn("Arguments are not satisfying condition to run BA",
                      RuntimeWarning)
        return poses, points

    return run_ba(viewpoint_indices, point_indices, poses, points,
                  keypoints_true, device=device)
