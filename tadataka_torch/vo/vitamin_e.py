"""VITAMIN-E dense feature tracking: curvature extrema and affine flow
(counterpart of ``tadataka_tpu/vo/vitamin_e.py``).

Keypoint tables with persistent integer ids, the affine flow between
frames (IRLS over feature matches), hill-climb correction on the image
curvature, keypoints spawned in newly visible areas, id-intersection
matching across frames, and triangulation of the surviving tracks; the
VO bootstraps from the essential matrix and localizes later frames by
PnP against the tracks' points.

Where the work runs:
- On the device: FAST/BRIEF, matching, the IRLS fits, the affine maps,
  the curvature, the top-k of its extrema, the hill climb over all
  keypoints, the range tests, RANSAC, PnP and triangulation.
- On the host: the integer-id bookkeeping in numpy, as in the JAX
  package (``np.intersect1d`` and the dicts).  ``KeypointFrame`` holds
  host arrays.
Each frame reads the device a counted number of times: the flow's kept
matches (one read), the tracked keypoints with the new area's extrema
(one read), the pose (one read; RANSAC's and PnP's small factorizations
run on the host, ``core/solvers.py``) and the triangulated tracks (one
read).  Every stage gives the same bits on the CPU and the card.

Marks for ``utils/timing.py``: the root span ``ve.estimate`` (it carries
the frame), the stages above, a ``sync.ve.<site>`` span and count at
each of those reads (``extrema``, ``matches``, ``tracks``, ``pose``,
``triangulate``) and the counters ``ve.tracked`` (tracks carried into
the frame), ``ve.spawned`` (keypoints of the new area), ``ve.pnp_points``
(mapped tracks handed to PnP) and ``ve.triangulated`` (points written).
Probes (``capture()``): the affine flow (``flow``: ``matrix``), beside
the RANSACs' own (``RANSAC pose_change`` and ``essential`` on frame 1,
``RANSAC pnp`` after).

Randomness: ``rng``, a ``torch.Generator`` (by default one seeded with
3939 on the device, as the JAX package draws from ``PRNGKey(3939)``
where ``_bootstrap`` and ``_localize`` pass no key) or a callable
``uniform(site, shape)`` (see ``features/ransac.py``); the matcher, the
essential-matrix RANSAC ("pose_change") and PnP ("pnp") draw from it.
"""

from functools import reduce
from typing import NamedTuple

import numpy as np
import torch

from tadataka_torch.core.image_range import is_in_image_range
from tadataka_torch.core.pose import Pose
from tadataka_torch.core.triangulation import (
    compute_depth_mask, linear_triangulation, pairwise_triangulation)
from tadataka_torch.dataset.image_io import rgb2gray
from tadataka_torch.device import resolve_device, upload
from tadataka_torch.features.brief import extract_features
from tadataka_torch.features.curvature import (
    compute_image_curvature, curvature_extrema, extract_curvature_extrema)
from tadataka_torch.features.extrema_tracker import ExtremaTracker
from tadataka_torch.features.flow import estimate_affine_transform
from tadataka_torch.features.matching import Matcher
from tadataka_torch.features.ransac import default_generator
from tadataka_torch.pose_estimation.epipolar import estimate_pose_change
from tadataka_torch.pose_estimation.pnp import solve_pnp_packed
from tadataka_torch.utils.exceptions import (
    NotEnoughInliersException, print_error)
from tadataka_torch.utils.timing import count, probe, span, sync_point


class KeypointFrame(NamedTuple):
    """Tracked keypoints of one frame: persistent ids + [x, y] coords."""
    ids: np.ndarray     # (N,) int64
    coords: np.ndarray  # (N, 2) float32


def create_keypoint_frame(start_id, keypoints):
    n = len(keypoints)
    return KeypointFrame(np.arange(start_id, start_id + n, dtype=np.int64),
                         np.asarray(keypoints, np.float32))


def init_keypoint_frame(image, percentile=98.0, max_keypoints=2048):
    """The curvature extrema of ``image`` (a tensor) with ids from 0."""
    kps, mask = extract_curvature_extrema(image, percentile=percentile,
                                          max_keypoints=max_keypoints)
    packed = torch.cat([kps, mask[:, None].to(kps.dtype)], 1)
    with sync_point("sync.ve.extrema"):
        packed = packed.cpu().numpy()
    return create_keypoint_frame(0, packed[packed[:, 2] > 0, :2])


def estimate_flow(features0, features1, matcher=None):
    """Affine flow from frame 0 to frame 1 by robust IRLS over the
    matches (one host read: the kept matches)."""
    matcher = matcher or Matcher()
    matches = matcher(features0, features1)
    with sync_point("sync.ve.matches"):
        idx = matches.indices[matches.mask]
    return estimate_affine_transform(features0.keypoints[idx[:, 0]],
                                     features1.keypoints[idx[:, 1]])


def _new_area(curvature, flow01, percentile, max_keypoints):
    """The extrema of frame 1's curvature and the mask of those whose
    back-projection leaves frame 0, on the device."""
    kps, mask = curvature_extrema(curvature, percentile, max_keypoints)
    outside = ~is_in_image_range(flow01.inverse(kps), curvature.shape)
    return kps, mask & outside


def keypoints_from_new_area(image1, flow01, percentile=98.0,
                            max_keypoints=2048):
    """Extrema of frame 1 whose back-projection leaves frame 0 (host
    array)."""
    kps, keep = _new_area(compute_image_curvature(image1), flow01,
                          percentile, max_keypoints)
    packed = torch.cat([kps, keep[:, None].to(kps.dtype)], 1).cpu().numpy()
    return packed[packed[:, 2] > 0, :2]


class Tracker:
    """Track a KeypointFrame into the next image: predict with the affine
    flow, correct by the curvature hill climb, drop out-of-frame tracks,
    spawn new keypoints in the newly visible area (one host read)."""

    def __init__(self, flow01, image1, lambda_):
        self.flow01 = flow01
        self.image1 = image1
        self.lambda_ = lambda_

    def __call__(self, keypoints0: KeypointFrame) -> KeypointFrame:
        device = self.image1.device
        with span("curvature + climb"):
            curvature = compute_image_curvature(self.image1)
            tracker = ExtremaTracker(curvature, self.lambda_)
            coords0 = upload(keypoints0.coords, device)
            corrected = tracker.optimize(self.flow01(coords0))
            in_range = is_in_image_range(corrected, self.image1.shape)
        with span("new area"):
            new_kps, keep = _new_area(curvature, self.flow01, 98.0, 2048)
        n = len(corrected)
        packed = torch.cat([
            torch.cat([corrected, in_range[:, None].to(corrected.dtype)], 1),
            torch.cat([new_kps, keep[:, None].to(new_kps.dtype)], 1)])
        with sync_point("sync.ve.tracks"):
            packed = packed.cpu().numpy()
        tracked, new = packed[:n], packed[n:]
        in_range = tracked[:, 2] > 0
        new_kps = new[new[:, 2] > 0, :2]

        ids1 = keypoints0.ids[in_range]
        count("ve.tracked", len(ids1))
        count("ve.spawned", len(new_kps))
        next_id = (keypoints0.ids[-1] + 1) if len(keypoints0.ids) else 0
        new_ids = np.arange(next_id, next_id + len(new_kps), dtype=np.int64)
        return KeypointFrame(np.concatenate([ids1, new_ids]),
                             np.concatenate([tracked[in_range, :2],
                                             new_kps]).astype(np.float32))


def match_keypoints(keypoints0: KeypointFrame, keypoints1: KeypointFrame):
    """(n, 2) row indices of tracks present in both frames."""
    _, i0, i1 = np.intersect1d(keypoints0.ids, keypoints1.ids,
                               return_indices=True)
    return np.column_stack([i0, i1])


def match_multiple_keypoints(keypoint_frames):
    """Row indices of tracks shared by every frame, (n, n_frames)."""
    shared = reduce(np.intersect1d, [kf.ids for kf in keypoint_frames])
    matches = np.empty((len(shared), len(keypoint_frames)), dtype=np.int64)
    for i, kf in enumerate(keypoint_frames):
        _, _, idx = np.intersect1d(shared, kf.ids, return_indices=True)
        matches[:, i] = idx
    return matches


def track_sequence(images, lambda_=0.5, matcher=None, patch_size=64,
                   fast_threshold=50.0 / 255.0, max_keypoints=512):
    """The tracking chain over images (float32 tensors, all on one
    device): a KeypointFrame per image, with persistent ids."""
    matcher = matcher or Matcher()
    features = [extract_features(im, max_keypoints=max_keypoints,
                                 threshold=fast_threshold,
                                 patch_size=patch_size)
                for im in images]
    keypoints = [init_keypoint_frame(images[0])]
    for i in range(len(images) - 1):
        flow01 = estimate_flow(features[i], features[i + 1], matcher)
        keypoints.append(Tracker(flow01, images[i + 1], lambda_)(
            keypoints[i]))
    return keypoints


def _pose_from_flat(flat):
    """Pose of CPU float32 tensors from a host [R.ravel(), t, ...]."""
    flat = np.asarray(flat, np.float32)
    return Pose(torch.from_numpy(flat[:9].reshape(3, 3).copy()),
                torch.from_numpy(flat[9:12].copy()))


class VitaminEVO:
    """VITAMIN-E visual odometry: dense extrema tracking with pose
    estimation from the tracks.
    - frame 1: essential-matrix bootstrap (scale-free) over the tracks;
    - frame k: PnP against the triangulated track map, then
      triangulation of the tracks not yet in the map, each against its
      first observation (the longest parallax), and re-triangulation of
      mapped tracks whose parallax grew.
    Poses are world -> camera ``Pose`` objects of float32 CPU tensors;
    ``estimate`` returns camera -> world.  The stages extract, flow
    (matching and IRLS), "curvature + climb", "new area" (the spawn),
    pose and triangulate are marked for ``utils/timing.py``.
    """

    def __init__(self, camera_model, lambda_=0.5, matcher=None,
                 fast_threshold=50.0 / 255.0, max_keypoints=512,
                 patch_size=64, percentile=98.0, max_track_keypoints=2048,
                 pnp_threshold=0.005, min_track_gap=1, device="cuda",
                 rng=None):
        self.device = resolve_device(device)
        self.rng = rng if rng is not None else default_generator(self.device)
        self.camera_model = camera_model.to(self.device)
        self.lambda_ = lambda_
        self.matcher = matcher if matcher is not None else Matcher(
            rng=self.rng)
        self.fast_threshold = fast_threshold
        self.max_keypoints = max_keypoints
        self.patch_size = patch_size
        self.percentile = percentile
        self.max_track_keypoints = max_track_keypoints
        self.pnp_threshold = pnp_threshold
        self.min_track_gap = min_track_gap

        self.poses_cw = []        # world->camera per frame
        self.keypoints = []       # KeypointFrame per frame
        self._features = None     # detector features of the latest frame
        self.points = {}          # track id -> (3,) world point
        self._first_obs = {}      # track id -> (frame_idx, (2,) pixel xy)
        self._tri_gap = {}        # track id -> frame gap used to triangulate

    @property
    def last_features(self):
        """The FAST/BRIEF ``Features`` of the latest frame, which the next
        frame's flow matches against."""
        return self._features

    @property
    def first_observations(self):
        """Track id -> (frame index, (2,) pixel xy) of its first
        sighting, the view each track is triangulated against."""
        return self._first_obs

    @property
    def triangulation_gaps(self):
        """Mapped track id -> the frame gap its point was triangulated
        over."""
        return self._tri_gap

    def _normalize(self, coords):
        """Normalized coordinates of host pixel coords, on the device."""
        return self.camera_model.normalize(upload(
            np.asarray(coords, np.float32), self.device))

    def _record_first_obs(self, frame_idx, kp: KeypointFrame):
        for i, tid in enumerate(kp.ids):
            if tid not in self._first_obs:
                self._first_obs[tid] = (frame_idx, kp.coords[i])

    def _triangulate_new(self, frame_idx, kp: KeypointFrame):
        """(Re-)triangulate tracks against their first observation: new
        tracks once they reach ``min_track_gap`` frames of parallax, and
        mapped tracks whenever the gap grew.  All of them in one batch,
        each row against its own first frame's pose (one host read)."""
        def wants(tid):
            if tid not in self._first_obs:
                return False
            gap = frame_idx - self._first_obs[tid][0]
            if gap < self.min_track_gap:
                return False
            return tid not in self.points or gap > self._tri_gap.get(tid, 0)

        sel = [i for i, tid in enumerate(kp.ids) if wants(tid)]
        if not sel:
            return
        first = [self._first_obs[kp.ids[i]] for i in sel]
        R0 = np.stack([self.poses_cw[j].R.numpy() for j, _ in first])
        t0 = np.stack([self.poses_cw[j].t.numpy() for j, _ in first])
        pose1 = self.poses_cw[frame_idx]
        points, depths = pairwise_triangulation(
            upload(R0, self.device), upload(t0, self.device),
            upload(pose1.R, self.device), upload(pose1.t, self.device),
            self._normalize(np.stack([xy for _, xy in first])),
            self._normalize(kp.coords[sel]))
        ok = compute_depth_mask(depths) & torch.isfinite(points).all(dim=1)
        packed = torch.cat([points, ok[:, None].to(points.dtype)], 1)
        with sync_point("sync.ve.triangulate"):
            packed = packed.cpu().numpy()
        written = 0
        for i, (j, _), row in zip(sel, first, packed):
            if row[3] > 0:
                tid = kp.ids[i]
                self.points[tid] = row[:3]
                self._tri_gap[tid] = frame_idx - j
                written += 1
        count("ve.triangulated", written)

    def estimate(self, image):
        """Process a frame (grayscale or RGB, host array or tensor);
        returns the camera -> world Pose, or None if tracking failed."""
        with span("ve.estimate", frame=len(self.poses_cw)):
            return self._estimate(image)

    def _estimate(self, image):
        if isinstance(image, torch.Tensor):
            image = image.detach().cpu().numpy()
        image = np.asarray(image)
        if image.ndim == 3:
            image = rgb2gray(image)
        image = upload(np.asarray(image, np.float32), self.device)

        with span("extract"):
            feats = extract_features(image, max_keypoints=self.max_keypoints,
                                     threshold=self.fast_threshold,
                                     patch_size=self.patch_size)

        if not self.poses_cw:
            kp = init_keypoint_frame(image, self.percentile,
                                     self.max_track_keypoints)
            self.keypoints.append(kp)
            self._features = feats
            self.poses_cw.append(Pose.identity())
            self._record_first_obs(0, kp)
            return Pose.identity()

        k = len(self.poses_cw)
        with span("flow"):
            flow01 = estimate_flow(self._features, feats, self.matcher)
        probe("flow", matrix=flow01.matrix)
        kp1 = Tracker(flow01, image, self.lambda_)(self.keypoints[-1])

        with span("pose"):
            if k == 1:
                pose_cw = self._bootstrap(kp1)
            else:
                pose_cw = self._localize(kp1)
        if pose_cw is None:
            return None

        self.poses_cw.append(pose_cw)
        self.keypoints.append(kp1)
        self._features = feats
        self._record_first_obs(k, kp1)
        with span("triangulate"):
            self._triangulate_new(k, kp1)
        return pose_cw.inv()

    def _bootstrap(self, kp1):
        matches = match_keypoints(self.keypoints[0], kp1)
        if matches.shape[0] < 8:
            return None
        xy0 = self.keypoints[0].coords[matches[:, 0]]
        xy1 = kp1.coords[matches[:, 1]]
        # world->cam1 directly: frame 0 is the world origin
        pose = estimate_pose_change(self._normalize(xy0),
                                    self._normalize(xy1), rng=self.rng)
        flat = torch.cat([pose.R.reshape(-1), pose.t])
        with sync_point("sync.ve.pose"):
            flat = flat.cpu().numpy()
        return _pose_from_flat(flat)

    def _localize(self, kp1):
        sel = [i for i, tid in enumerate(kp1.ids) if tid in self.points]
        if len(sel) < 6:
            return None
        pts = np.stack([self.points[kp1.ids[i]] for i in sel]).astype(
            np.float32)
        count("ve.pnp_points", len(sel))
        try:
            packed = solve_pnp_packed(
                upload(pts, self.device),
                self._normalize(kp1.coords[sel]), np.ones(len(sel), bool),
                rng=self.rng, reprojection_threshold=self.pnp_threshold,
                device=self.device)
            with sync_point("sync.ve.pose"):
                packed = packed.cpu().numpy()
            if packed[12] < 1.0:
                raise NotEnoughInliersException("No inliers found")
        except NotEnoughInliersException as e:
            print_error(str(e))
            return None
        return _pose_from_flat(packed)


def triangulate_tracks(camera_models, poses, keypoint_frames):
    """Triangulation of the tracks shared by every given frame, from
    world -> camera poses; returns (points (N, 3), depths (V, N)) on the
    first camera model's device."""
    matches = match_multiple_keypoints(keypoint_frames)
    device = camera_models[0].camera_parameters.focal_length.device
    normalized = torch.stack([
        cm.normalize(upload(kf.coords[matches[:, i]], device))
        for i, (cm, kf) in enumerate(zip(camera_models, keypoint_frames))])
    rotations = torch.stack([p.R for p in poses]).to(device)
    translations = torch.stack([p.t for p in poses]).to(device)
    return linear_triangulation(rotations, translations, normalized)
