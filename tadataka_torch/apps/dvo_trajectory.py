"""DVO trajectory over an RGB-D sequence (counterpart of
``tadataka_tpu/apps/dvo_trajectory.py``): frame-to-frame DVO pose changes
chained into a camera -> world trajectory.

Per frame: the gray image (converted on the host) and the depth map go
to the device, the inverse-compositional pyramid estimates pose10
against the previous frame with the normalized grids cached per image
shape, and the world pose becomes pose_wc * pose10^-1, composed with
``rounding.matmul_small`` so that the CPU and the card give the same
bits.
"""

import numpy as np
import torch

from tadataka_torch.core.pose import Pose
from tadataka_torch.core.rounding import matmul_small
from tadataka_torch.dataset.image_io import rgb2gray
from tadataka_torch.device import resolve_device
from tadataka_torch.utils.timing import span, sync_point
from tadataka_torch.vo.dvo import PoseChangeEstimator, estimate_pose_pyramid


def _host_array(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class DvoTrajectory:
    def __init__(self, camera_model, weights="huber", n_coarse_to_fine=5,
                 max_iter=20, device="cuda"):
        """``weights``: a weight kind of ``vo.dvo.WEIGHT_KINDS`` that
        needs no map ("huber", "tukey", "student-t", "none"); anything
        that is not a string means "none".  ``device``: where DVO runs,
        the card unless the caller asks for "cpu"; raises if it names
        CUDA and there is none."""
        self.device = resolve_device(device)
        self.camera_model = camera_model.to(self.device)
        self.weights = weights
        self.estimator = PoseChangeEstimator(
            self.camera_model, self.camera_model,
            n_coarse_to_fine=n_coarse_to_fine, max_iter=max_iter)
        self.pose_wc = Pose.identity(device=self.device)
        self.trajectory = [self.pose_wc]
        self._prev = None
        self._prepared = {}
        self._frame_id = 0

    def _prepare(self, frame):
        image = torch.from_numpy(rgb2gray(_host_array(frame.image)))
        depth = torch.as_tensor(_host_array(frame.depth_map),
                                dtype=torch.float32)
        with sync_point("sync.dvo.image_upload", 2):
            return image.to(self.device), depth.to(self.device)

    def prefetch(self, frame):
        """Convert and upload the frame now; a later ``estimate(frame)``
        picks it up."""
        self._prepared[id(frame)] = self._prepare(frame)

    def estimate(self, frame):
        """frame: a Frame with .image and .depth_map.  Returns pose_wc
        (on the device)."""
        with span("dvo.estimate", frame=self._frame_id):
            self._frame_id += 1
            with span("dvo.prepare"):
                prepared = self._prepared.pop(id(frame), None)
                image, depth = (prepared if prepared is not None
                                else self._prepare(frame))
            if self._prev is not None:
                prev_image, prev_depth = self._prev
                e = self.estimator
                weight_kind = (self.weights if isinstance(self.weights, str)
                               else "none")
                with span("dvo.track"):
                    R10, t10 = estimate_pose_pyramid(
                        e.camera_model0, e.camera_model0, prev_image,
                        prev_depth, image, torch.ones_like(prev_image),
                        torch.eye(3, device=self.device),
                        torch.zeros(3, device=self.device),
                        e.n_coarse_to_fine, e.max_iter, e.layer_size_ratio,
                        weight_kind, "ic", e.grids(image.shape))
                with span("dvo.compose"):
                    # pose_wc <- pose_wc * pose10^-1
                    R_new = matmul_small(self.pose_wc.R, R10.T)
                    t_new = self.pose_wc.t - matmul_small(
                        R_new, t10[:, None])[:, 0]
                    self.pose_wc = Pose(R_new, t_new)
                    self.trajectory.append(self.pose_wc)
            self._prev = (image, depth)
            return self.pose_wc

    def positions(self):
        return np.stack([p.t.cpu().numpy() for p in self.trajectory])
