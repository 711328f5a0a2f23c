"""Feature-based visual odometry: a keyframe window, PnP, triangulation
and windowed bundle adjustment (counterpart of
``tadataka_tpu/vo/feature_based.py``).

- The first two frames bootstrap from the essential matrix, refined by a
  two-view BA; every later frame matches against the window's keyframes,
  localizes by PnP against the triangulated points, re-associates the
  window's map points by spatially gated matching around their
  projections and solves PnP again (guided local-map localization),
  triangulates the fresh matches (one keypoint per point) and runs BA
  over the window once it holds 3 keyframes; the oldest keyframe leaves
  a full window.
- 3D points get increasing integer ids in plain dicts.
- Device work (detection, descriptors, matching, RANSAC, PnP,
  triangulation, BA) runs on ``device``; the keyframe bookkeeping, the
  projection of the map points for the guided search and scipy's
  rotation maps run on the host, which reads each device result once.
  Host uploads go through pinned memory without blocking.
- Randomness: ``rng``, a ``torch.Generator`` (by default one seeded with
  3939 on ``device``) or a callable ``uniform(site, shape)`` (see
  ``features/ransac.py``).  The sites: ("match", i, V) for the matcher's
  i-th of V pairs, "pose_change" for the essential-matrix bootstrap,
  "pnp" for the PnP against the matched points and "guided_pnp" for the
  guided one.
- Poses are world -> camera ``Pose`` objects of float32 CPU tensors;
  ``estimate`` returns camera -> world.
- ``frame_stats`` holds what the host read of the last frame: its valid
  keypoints, the matches kept per window keyframe (host index arrays)
  and the inliers of the PnP against the matched points (0 where none
  ran).  The stages extract, match, "PnP + guided", triangulate and BA
  are marked for ``utils/timing.py``.
"""

import numpy as np
import torch

from tadataka_torch.ba.api import host, try_run_ba
from tadataka_torch.ba.schur import lm_solve
from tadataka_torch.core.pose import Pose
from tadataka_torch.core.so3 import exp_so3, log_so3
from tadataka_torch.core.triangulation import (
    compute_depth_mask, pairwise_triangulation, two_view_triangulation)
from tadataka_torch.dataset.image_io import rgb2gray
from tadataka_torch.device import resolve_device, upload
from tadataka_torch.features.brief import extract_features
from tadataka_torch.features.matching import (
    Matcher, match_descriptors_guided)
from tadataka_torch.features.ransac import default_generator
from tadataka_torch.pose_estimation.epipolar import estimate_pose_change
from tadataka_torch.pose_estimation.pnp import (
    solve_pnp_packed, solve_pnp_ransac)
from tadataka_torch.utils.exceptions import (
    NotEnoughInliersException, print_error)
from tadataka_torch.utils.timing import probe, span


def _pose_from_flat(flat):
    """Pose of CPU float32 tensors from a host [R.ravel(), t, ...]."""
    flat = np.asarray(flat, np.float32)
    return Pose(torch.from_numpy(flat[:9].reshape(3, 3).copy()),
                torch.from_numpy(flat[9:12].copy()))


class _Extraction:
    """One frame's features on the device and their host copy in flight."""

    def __init__(self, feats, normalized, packed, event):
        self.feats, self.normalized = feats, normalized
        self.packed, self.event = packed, event

    def result(self):
        """(feats, keypoints_px, normalized, normalized_dev, n_valid)."""
        if self.event is not None:
            self.event.synchronize()
        packed = self.packed.numpy()
        return (self.feats, packed[:, :2], packed[:, 2:4], self.normalized,
                int(packed[:, 4].sum()))


class FeatureBasedVO:
    def __init__(self, matcher=None, window_size=8, min_matches=60,
                 max_keypoints=512, patch_size=64,
                 fast_threshold=50.0 / 255.0, guided_radius=0.02,
                 pnp_threshold=None, device="cuda", rng=None):
        self.device = resolve_device(device)
        self.rng = rng if rng is not None else default_generator(self.device)
        self.matcher = matcher if matcher is not None else Matcher(
            rng=self.rng)
        self.window_size = window_size
        self.min_matches = min_matches
        self.max_keypoints = max_keypoints
        self.patch_size = patch_size
        self.fast_threshold = fast_threshold
        # None: the adaptive gate 3 * rms / n of calc_reprojection_threshold
        self.pnp_threshold = pnp_threshold
        # the guided search's window (normalized coords) around each map
        # point's projection; None turns the guided localization off
        self.guided_radius = guided_radius

        self.active_viewpoints = []
        self.poses = {}           # viewpoint -> Pose (world -> camera)
        self.features = {}        # viewpoint -> Features (normalized kps)
        self.raw_keypoints = {}   # viewpoint -> (K, 2) pixel keypoints
        self._kp_np = {}          # viewpoint -> (K, 2) normalized, host
        self._current_kp_np = None
        # viewpoint -> {keypoint index: point id}
        self.correspondences = {}
        self.point_dict = {}      # point id -> (3,) np.ndarray
        self.point_colors = {}    # point id -> color
        self._next_point_id = 0
        self._camera = (None, None)   # (a frame's model, its device copy)
        self._prefetched = {}
        self.frame_stats = {}

    # ------------------------------------------------------------------ api

    def prefetch(self, frame):
        """Start ``frame``'s feature extraction on the device; the later
        ``estimate(frame)`` picks up its result."""
        self._prefetched[id(frame)] = self._extract_launch(
            frame.camera_model, frame.image)

    def estimate(self, frame):
        """Process a frame; returns the camera -> world Pose or None."""
        pending = self._prefetched.pop(id(frame), None)
        viewpoint = self.add(frame.camera_model, frame.image,
                             extracted=(pending.result() if pending
                                        else None))
        if viewpoint < 0:
            return None
        self.try_remove()
        return self.poses[viewpoint].inv()

    def export_points(self):
        ids = sorted(self.point_dict.keys())
        points = (np.array([self.point_dict[i] for i in ids]) if ids
                  else np.empty((0, 3)))
        colors = np.array([self.point_colors.get(i, 0.0) for i in ids])
        return points, colors

    def export_poses(self):
        return [self.poses[v] for v in sorted(self.poses.keys())]

    @property
    def n_active_keyframes(self):
        return len(self.active_viewpoints)

    # ------------------------------------------------------------ internals

    def _upload(self, array, dtype=None):
        """A host array on the device, through pinned memory without
        blocking on the card."""
        return upload(array, self.device, dtype)

    def _new_point_ids(self, n):
        ids = list(range(self._next_point_id, self._next_point_id + n))
        self._next_point_id += n
        return ids

    def _camera_model(self, camera_model):
        if self._camera[0] is not camera_model:
            self._camera = (camera_model, camera_model.to(self.device))
        return self._camera[1]

    def _extract_launch(self, camera_model, image):
        """Detection, descriptors and normalization on the device, and the
        start of one host copy of what the host indexes."""
        image = host(image)
        if image.ndim == 3:     # detection runs on gray
            image = rgb2gray(image)
        feats = extract_features(
            self._upload(image, torch.float32),
            max_keypoints=self.max_keypoints, threshold=self.fast_threshold,
            patch_size=self.patch_size)
        normalized = self._camera_model(camera_model).normalize(
            feats.keypoints)
        packed = torch.cat([feats.keypoints, normalized,
                            feats.mask[:, None].float()], dim=1)
        if self.device.type != "cuda":
            return _Extraction(feats, normalized, packed, None)
        host_copy = torch.empty(packed.shape, dtype=packed.dtype,
                                pin_memory=True)
        host_copy.copy_(packed, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return _Extraction(feats, normalized, host_copy, event)

    def _extract(self, camera_model, image):
        return self._extract_launch(camera_model, image).result()

    def _match(self, features1, viewpoints):
        """Match index arrays (n, 2) of the viewpoints with at least
        ``min_matches`` inliers, and those viewpoints; one host read."""
        indices_dev, masks_dev = self.matcher.match_many(
            [self.features[v] for v in viewpoints], features1)
        V, K = masks_dev.shape
        packed = torch.cat([indices_dev.reshape(V, -1), masks_dev.long()],
                           dim=1).cpu().numpy()
        indices = packed[:, :2 * K].reshape(V, K, 2)
        masks = packed[:, 2 * K:].astype(bool)
        pairs = []
        kept_viewpoints = []
        for v, mask, idx in zip(viewpoints, masks, indices):
            sel = idx[mask]
            if len(sel) >= self.min_matches:
                pairs.append(sel)
                kept_viewpoints.append(v)
        self.frame_stats["matches"] = pairs
        if not pairs:
            raise NotEnoughInliersException("Not enough matches found")
        return pairs, kept_viewpoints

    def add(self, camera_model, image, min_keypoints=8, extracted=None):
        image = host(image)
        with span("extract"):
            feats, keypoints_px, normalized, normalized_dev, n_valid = (
                extracted if extracted is not None
                else self._extract(camera_model, image))
        self.frame_stats = dict(keypoints=n_valid, matches=[], pnp_inliers=0)
        if n_valid <= min_keypoints:
            print_error("Keypoints not sufficient")
            return -1

        # the matcher reads descriptors and mask; geometry reads the
        # normalized keypoints
        features1 = feats._replace(keypoints=normalized_dev)
        self._current_kp_np = normalized

        viewpoint1 = (self.active_viewpoints[-1] + 1
                      if self.active_viewpoints else 0)

        if not self.active_viewpoints:
            pose1 = Pose.identity()
            self.correspondences[viewpoint1] = {}
            new_points = {}
        else:
            try:
                pose1, new_points, corr_updates, correspondence1 = \
                    self._estimate_pose_points(features1)
            except NotEnoughInliersException as e:
                print_error(e.message)
                return -1
            for v, upd in corr_updates.items():
                self.correspondences[v].update(upd)
            self.correspondences[viewpoint1] = correspondence1

        self.poses[viewpoint1] = pose1
        self.point_dict.update(new_points)
        # colors from the raw image at the keypoint pixel
        for kp_idx, pid in self.correspondences[viewpoint1].items():
            if pid in new_points:
                x, y = keypoints_px[kp_idx].astype(int)
                y = min(max(y, 0), image.shape[0] - 1)
                x = min(max(x, 0), image.shape[1] - 1)
                self.point_colors[pid] = image[y, x]

        self.features[viewpoint1] = features1
        self.raw_keypoints[viewpoint1] = keypoints_px
        self._kp_np[viewpoint1] = normalized
        self.active_viewpoints.append(viewpoint1)

        if len(self.active_viewpoints) >= 3:
            with span("BA"):
                self.run_ba(self.active_viewpoints)
        return viewpoint1

    def _estimate_pose_points(self, features1):
        if len(self.active_viewpoints) == 1:
            return self._init_first_two(features1, self.active_viewpoints[0])

        with span("match"):
            pairs, viewpoints = self._match(features1,
                                            self.active_viewpoints)
        with span("PnP + guided"):
            pose1 = self._solve_pnp(viewpoints, pairs)
            guided_assoc = {}
            if self.guided_radius is not None:
                pose1, guided_assoc = self._guided_localize(features1, pose1)
        with span("triangulate"):
            pose1, new_points, corr_updates, correspondence1 = \
                self._triangulate_new(viewpoints, pairs, pose1)
        # the guided associations that triangulation left free
        used_pids = set(correspondence1.values())
        for i1, pid in guided_assoc.items():
            if i1 not in correspondence1 and pid not in used_pids:
                correspondence1[i1] = pid
                used_pids.add(pid)
        return pose1, new_points, corr_updates, correspondence1

    def _init_first_two(self, features1, viewpoint0):
        pose0 = self.poses[viewpoint0]
        pairs, _ = self._match(features1, [viewpoint0])
        matches01 = pairs[0]

        kp0 = self._kp_np[viewpoint0][matches01[:, 0]]
        kp1 = self._current_kp_np[matches01[:, 1]]
        pose1 = estimate_pose_change(self._upload(kp0), self._upload(kp1),
                                     rng=self.rng)
        pose1 = _pose_from_flat(
            torch.cat([pose1.R.reshape(-1), pose1.t]).cpu().numpy())
        points, mask = self._triangulate(pose0, pose1, kp0, kp1)

        # a two-view BA: the essential estimate is noisy at small
        # parallax; a few LM iterations on the reprojection error tighten
        # the relative pose and the first map, and the gauge (pose0 =
        # identity, |t1| = 1) is restored afterwards
        pose1, points = self._refine_two_view(
            kp0[mask], kp1[mask], pose1, points[mask])

        ids = self._new_point_ids(int(mask.sum()))
        new_points = {}
        corr0, corr1 = {}, {}
        for pid, (i0, i1), pt in zip(ids, matches01[mask], points):
            new_points[pid] = pt
            corr0[int(i0)] = pid
            corr1[int(i1)] = pid
        return pose1, new_points, {viewpoint0: corr0}, corr1

    def _pose_on_device(self, pose):
        return Pose(self._upload(host(pose.R)), self._upload(host(pose.t)))

    def _triangulate(self, pose0, pose1, keypoints0, keypoints1):
        """Two-view triangulation; (points (n, 3), in-front mask (n,))."""
        points, depths = two_view_triangulation(
            self._pose_on_device(pose0), self._pose_on_device(pose1),
            self._upload(keypoints0), self._upload(keypoints1))
        flat = torch.cat([points.reshape(-1),
                          compute_depth_mask(depths).float()]).cpu().numpy()
        n = len(keypoints0)
        probe("triangulate", points=points, depths=depths)
        return flat[:3 * n].reshape(n, 3), flat[3 * n:].astype(bool)

    def _refine_two_view(self, kp0, kp1, pose1, points):
        n = len(points)
        if n < 12:
            return pose1, points
        vi = np.concatenate([np.zeros(n, np.int64), np.ones(n, np.int64)])
        pi_ = np.concatenate([np.arange(n), np.arange(n)])
        x_true = np.concatenate([kp0, kp1]).astype(np.float32)
        R1 = self._upload(host(pose1.R))
        pose_params = torch.stack([
            torch.zeros(6, device=self.device),
            torch.cat([log_so3(R1), self._upload(host(pose1.t))])])
        new_params, new_points, _ = lm_solve(
            pose_params, self._upload(np.asarray(points, np.float32)),
            self._upload(vi), self._upload(pi_), self._upload(x_true),
            max_iter=10, relative_error_threshold=1e-4)
        flat = torch.cat([exp_so3(new_params[:, :3]).reshape(-1),
                          new_params[:, 3:].reshape(-1),
                          new_points.reshape(-1)]).cpu().numpy()
        R0, R1 = flat[:18].reshape(2, 3, 3)
        t0, t1 = flat[18:24].reshape(2, 3)
        new_points = flat[24:].reshape(n, 3)
        probe("two-view BA", params=new_params, points=new_points)
        # re-gauge: the world is camera 0's frame, the baseline unit
        R_rel = R1 @ R0.T
        t_rel = t1 - R_rel @ t0
        s = np.linalg.norm(t_rel)
        if s < 1e-9 or not np.isfinite(s):
            return pose1, points
        pts = (new_points @ R0.T + t0) / s
        return Pose(torch.from_numpy(R_rel), torch.from_numpy(t_rel / s)), pts

    def _guided_localize(self, features1, pose1):
        """Local-map tracking: project the window's map points through the
        PnP pose, re-associate them by spatially gated descriptor matching
        (``match_descriptors_guided``) and solve PnP again on the denser
        set.  Returns (pose, {keypoint in frame 1: point id})."""
        # each map point's descriptor from its latest observation, gathered
        # on the device from the window's descriptors
        window = [v for v in self.active_viewpoints if v in self.features]
        v_pos = {v: i for i, v in enumerate(window)}
        pids, pts, sel = [], [], []
        seen = set()
        for v in reversed(window):
            for kp_idx, pid in self.correspondences[v].items():
                if pid in seen or pid not in self.point_dict:
                    continue
                seen.add(pid)
                pids.append(pid)
                pts.append(self.point_dict[pid])
                sel.append((v_pos[v], kp_idx))
        if len(pids) < 6:
            return pose1, {}

        pts = np.asarray(pts, np.float32)
        sel = self._upload(np.asarray(sel, np.int64))
        descs = torch.stack([self.features[v].descriptors
                             for v in window])[sel[:, 0], sel[:, 1]]

        P = pts @ host(pose1.R).T + host(pose1.t)
        in_front = P[:, 2] > 1e-6
        pred = P[:, :2] / np.maximum(P[:, 2:3], 1e-16)   # host-side pi

        matches = match_descriptors_guided(
            descs, features1.descriptors, self._upload(in_front),
            features1.mask, self._upload(pred), features1.keypoints,
            self.guided_radius)
        obj = self._upload(pts)[matches.indices[:, 0]]
        img = features1.keypoints[matches.indices[:, 1]]
        pose, inliers = solve_pnp_ransac(
            obj, img, matches.mask, self.rng,
            reprojection_threshold=self.pnp_threshold, site="guided_pnp")
        packed = torch.cat([
            pose.R.reshape(-1), pose.t,
            torch.sum(inliers).float()[None],
            torch.sum(matches.mask).float()[None],
            matches.indices.reshape(-1).float(),
            matches.mask.float()]).cpu().numpy()
        n_inl, n_matched = packed[12], packed[13]
        K = len(pids)
        idx = packed[14:14 + 2 * K].reshape(K, 2).astype(np.int64)
        m = packed[14 + 2 * K:].astype(bool)
        if n_matched < 6 or n_inl < 1:
            return pose1, {}
        assoc = {int(i1): pids[int(i0)] for i0, i1 in idx[m]}
        return _pose_from_flat(packed), assoc

    def _solve_pnp(self, viewpoints, pairs):
        """Localize against the already triangulated points."""
        object_points = []
        image_points = []
        for v, matches01 in zip(viewpoints, pairs):
            corr0 = self.correspondences[v]
            for i0, i1 in matches01:
                pid = corr0.get(int(i0))
                if pid is not None:
                    object_points.append(self.point_dict[pid])
                    image_points.append(self._current_kp_np[i1])
        if len(object_points) < 6:
            raise NotEnoughInliersException("No sufficient correspondences")
        n = len(object_points)
        packed = solve_pnp_packed(
            self._upload(np.asarray(object_points, np.float32)),
            self._upload(np.asarray(image_points, np.float32)),
            np.ones(n, bool), rng=self.rng,
            reprojection_threshold=self.pnp_threshold,
            device=self.device).cpu().numpy()
        self.frame_stats["pnp_inliers"] = int(packed[12])
        if packed[12] < 1.0:
            raise NotEnoughInliersException("No inliers found")
        return _pose_from_flat(packed)

    def _triangulate_new(self, viewpoints, pairs, pose1):
        """Triangulate the matches not triangulated yet, one keypoint of
        frame 1 per point."""
        used1 = set()
        used_pids = set()   # one keypoint per point
        new_points = {}
        corr_updates = {}
        correspondence1 = {}

        # which pairs are fresh, per viewpoint
        fresh_by_v = []
        for v, matches01 in zip(viewpoints, pairs):
            corr0 = self.correspondences[v]
            fresh = []
            for i0, i1 in matches01:
                if int(i1) in used1:
                    continue
                pid = corr0.get(int(i0))
                if pid is not None:
                    if pid in used_pids:
                        continue
                    # already triangulated: copy the association
                    used1.add(int(i1))
                    used_pids.add(pid)
                    correspondence1[int(i1)] = pid
                else:
                    used1.add(int(i1))
                    fresh.append((int(i0), int(i1)))
            if fresh:
                fresh_by_v.append((v, np.asarray(fresh)))

        # every viewpoint's fresh pairs through one batched triangulation
        # and one host read
        if fresh_by_v:
            R0l, t0l, kp0l, kp1l, segs = [], [], [], [], []
            for v, fresh in fresh_by_v:
                m = len(fresh)
                pv = self.poses[v]
                R0l.append(np.broadcast_to(host(pv.R), (m, 3, 3)))
                t0l.append(np.broadcast_to(host(pv.t), (m, 3)))
                kp0l.append(self._kp_np[v][fresh[:, 0]])
                kp1l.append(self._current_kp_np[fresh[:, 1]])
                segs.append((v, fresh, m))
            points_dev, depths_dev = pairwise_triangulation(
                self._upload(np.concatenate(R0l)),
                self._upload(np.concatenate(t0l)),
                self._upload(host(pose1.R)), self._upload(host(pose1.t)),
                self._upload(np.concatenate(kp0l)),
                self._upload(np.concatenate(kp1l)))
            n = len(points_dev)
            flat = torch.cat([points_dev.reshape(-1),
                              depths_dev.reshape(-1)]).cpu().numpy()
            points_all = flat[:3 * n].reshape(n, 3)
            probe("triangulate", points=points_dev, depths=depths_dev)
            mask_all = np.all(flat[3 * n:].reshape(2, n) > 0.0, axis=0)
            off = 0
            for v, fresh, m in segs:
                mask = mask_all[off:off + m]
                points = points_all[off:off + m]
                off += m
                ids = self._new_point_ids(int(mask.sum()))
                upd0 = {}
                for pid, (i0, i1), pt in zip(ids, fresh[mask], points[mask]):
                    new_points[pid] = pt
                    upd0[int(i0)] = pid
                    correspondence1[int(i1)] = pid
                corr_updates[v] = upd0

        return pose1, new_points, corr_updates, correspondence1

    def run_ba(self, viewpoints):
        """Windowed BA over the active keyframes."""
        point_ids = sorted({pid
                            for v in viewpoints
                            for pid in self.correspondences[v].values()})
        id_to_index = {pid: i for i, pid in enumerate(point_ids)}

        vi, pi_, keypoints = [], [], []
        for j, v in enumerate(viewpoints):
            kps = self._kp_np[v]
            for kp_idx, pid in self.correspondences[v].items():
                vi.append(j)
                pi_.append(id_to_index[pid])
                keypoints.append(kps[kp_idx])
        if not vi:
            return
        poses = [self.poses[v] for v in viewpoints]
        points = np.asarray([self.point_dict[pid] for pid in point_ids],
                            np.float32)
        new_poses, new_points = try_run_ba(
            np.asarray(vi), np.asarray(pi_), poses, points,
            np.asarray(keypoints, np.float32), device=self.device)
        probe("BA", points=new_points, R=np.stack([host(p.R) for p in new_poses]),
              t=np.stack([host(p.t) for p in new_poses]))
        for pid, pt in zip(point_ids, np.asarray(new_points)):
            self.point_dict[pid] = pt
        for v, pose in zip(viewpoints, new_poses):
            self.poses[v] = pose

    def try_remove(self):
        """Evict the oldest keyframe and free its per-viewpoint state once
        the window is over full; poses and the point map stay for
        export."""
        if self.n_active_keyframes <= self.window_size:
            return False
        v = self.active_viewpoints.pop(0)
        self.features.pop(v, None)
        self.raw_keypoints.pop(v, None)
        self.correspondences.pop(v, None)
        self._kp_np.pop(v, None)
        return True
