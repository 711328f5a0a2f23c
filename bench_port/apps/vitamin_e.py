"""Driver of a VitaminEVO configuration: builds the app from the
configuration's file (the RadTan camera included) through the port's
public constructors, hands it each frame as the host uint8 RGB image,
and keeps, for the frames sampled for the check, the state the frame
reads (``snapshot``), what it wrote (``estimate``'s result) and the
values the port probes on the way (``tadataka_torch.utils.timing``'s
``capture()``): the affine flow (``flow``), the bootstrap's RANSAC
(``RANSAC pose_change``: each trial's model, its inliers, the winner;
``essential``: the inliers of the refit) and PnP's (``RANSAC pnp``: each
trial's EPnP hypothesis, its inliers, the winner, and the inliers of
the refinement).  Nothing of the port is wrapped or replaced.

The per-layer metrics read the app's own spans and counters (``ve.*``,
``sync.ve.*``)."""

from typing import NamedTuple

import numpy as np
import torch

# frame 0 (the extrema), frame 1 (the bootstrap), frame 2 (the first
# PnP, the first re-triangulation), then frames until the shapes of
# the window have run: the map grows for a few frames after the
# bootstrap and every track's first observation leaves frame 0
WARM_FRAMES = 8
# the probes the check reads (stage names of ``capture()``)
PROBED = ("flow", "RANSAC pose_change", "essential", "RANSAC pnp")


class Snapshot(NamedTuple):
    """What a frame reads of the app, packed: ``frame``, the index of
    the frame about to run; the last KeypointFrame (``ids``,
    ``coords``); the previous frame's Features (``features``: keypoints,
    descriptors, mask); the first observations (``obs_ids``,
    ``first_frames``, ``first_coords``) of those tracks and of the ids
    past the last one that the app has seen before (a new keypoint takes
    the id after the last frame's last, so it may take one again); the
    mapped ones among them (``map_ids``, ``map_points``, ``map_gaps``:
    the frame gap they were triangulated at); the world -> camera poses
    of the frames those first observations name (``pose_frames``,
    ``poses`` (P, 3, 4)); and the generator's state (``rng_state``)."""
    frame: int
    ids: np.ndarray
    coords: np.ndarray
    features: tuple
    obs_ids: np.ndarray
    first_frames: np.ndarray
    first_coords: np.ndarray
    map_ids: np.ndarray
    map_points: np.ndarray
    map_gaps: np.ndarray
    pose_frames: np.ndarray
    poses: np.ndarray
    rng_state: torch.Tensor


class Output(NamedTuple):
    """A frame's result: the camera -> world 4x4 pose (None where the
    app lost track), the new KeypointFrame (``ids``, ``coords``), the
    world -> camera 3x4 pose, and, on a sampled frame, the tracks
    (re)triangulated in it (``written_ids``, ``written_points``) and
    the generator's state after it (``rng_state``) and the probed values
    (``probes``: {"stage/name": host array}, the last of each)."""
    pose_wc: np.ndarray
    ids: np.ndarray
    coords: np.ndarray
    pose_cw: np.ndarray
    written_ids: np.ndarray
    written_points: np.ndarray
    rng_state: torch.Tensor
    probes: dict


def _host_pose(pose):
    return np.concatenate([pose.R.numpy(), pose.t.numpy()[:, None]], 1)


class System:
    def __init__(self, config, loop, seed, device):
        from tadataka_torch.camera import CameraModel, CameraParameters
        from tadataka_torch.camera import NoDistortion, RadTan
        from tadataka_torch.vo.vitamin_e import VitaminEVO
        c = config["camera"]
        cm = CameraModel.create(
            CameraParameters.create((c["fx"], c["fy"]), (c["cx"], c["cy"])),
            NoDistortion() if c.get("radtan") is None
            else RadTan.create(c["radtan"]))
        self.vo = VitaminEVO(cm, device=device, **config["app_args"])
        self.warm_frames = WARM_FRAMES
        self._sampled = False

    def instrument(self, rec):
        # the check reads the port's probes (``estimate``); the metrics
        # its spans and counters
        pass

    def estimate(self, frame):
        from tadataka_torch.utils.timing import capture
        vo = self.vo
        sampled, self._sampled = self._sampled, False
        probes = None
        if sampled:
            with capture(PROBED) as values:
                pose = vo.estimate(frame.image)
            probes = {f"{stage}/{name}": value
                      for stage, name, value in values}
        else:
            pose = vo.estimate(frame.image)
        if pose is None:
            return None
        k = len(vo.poses_cw) - 1
        kp = vo.keypoints[-1]
        written_ids = written_points = rng_state = None
        if sampled:
            rng_state = vo.rng.get_state()
            first, gaps = vo.first_observations, vo.triangulation_gaps
            # a track was written in this frame where its gap is this
            # frame's distance to its first observation
            written_ids = np.array(
                [tid for tid in kp.ids if tid in vo.points
                 and gaps[tid] == k - first[tid][0]], np.int64)
            written_points = np.array(
                [vo.points[tid] for tid in written_ids],
                np.float32).reshape(-1, 3)
        T = np.eye(4)
        T[:3, :3] = pose.R.numpy()
        T[:3, 3] = pose.t.numpy()
        return Output(T, kp.ids, kp.coords, _host_pose(vo.poses_cw[k]),
                      written_ids, written_points, rng_state, probes)

    def snapshot(self):
        vo = self.vo
        self._sampled = True
        k = len(vo.poses_cw)
        if not k:
            return Snapshot(0, *([None] * 11), vo.rng.get_state())
        kp = vo.keypoints[-1]
        first_obs = vo.first_observations
        # the last key inserted is the largest id the app has given
        last = next(reversed(first_obs))
        start = int(kp.ids[-1]) + 1 if len(kp.ids) else 0
        obs_ids = np.concatenate([kp.ids, np.array(
            [tid for tid in range(start, last + 1) if tid in first_obs],
            np.int64)])
        first = [first_obs[tid] for tid in obs_ids]
        first_frames = np.array([j for j, _ in first], np.int64)
        first_coords = np.array([xy for _, xy in first],
                                np.float32).reshape(-1, 2)
        map_ids = np.array([tid for tid in obs_ids if tid in vo.points],
                           np.int64)
        map_points = np.array([vo.points[tid] for tid in map_ids],
                              np.float32).reshape(-1, 3)
        map_gaps = np.array([vo.triangulation_gaps[tid] for tid in map_ids],
                            np.int64)
        pose_frames = np.unique(first_frames)
        poses = np.stack([_host_pose(vo.poses_cw[j]) for j in pose_frames])
        return Snapshot(k, kp.ids, kp.coords, tuple(vo.last_features),
                        obs_ids, first_frames, first_coords, map_ids,
                        map_points, map_gaps, pose_frames, poses,
                        vo.rng.get_state())

    @staticmethod
    def read_pose(out):
        if out is None:
            raise RuntimeError("VitaminEVO lost track (estimate returned "
                               "None)")
        return out.pose_wc

    @staticmethod
    def finite(out):
        # the pose was read to the host and checked there
        return torch.ones((), dtype=torch.bool)

    def plan_mix(self, frames):
        return "no depth update"

    def release(self):
        self.vo = None

    def check(self, captures, loop, config, seed, device, err=None,
              control=False):
        from bench_port.reference import vitamin_e
        return vitamin_e.check(captures, loop, config, seed, device, err,
                               control)
