"""Semi-dense VO pipeline: DVO tracking + semi-dense depth mapping
(counterpart of ``tadataka_tpu/apps/semi_dense_vo.py``).

Per frame: the pose by DVO against the previous depth map (a user
callback may bootstrap the second frame), age increment, depth/variance
propagation, the planned depth update (or, with
``depth_update="scatter"``, the scattered estimator on every frame), 3x3
regularization, and the refframe history.

The host keeps the JAX app's pose bookkeeping exactly, because it decides
the plan: the planner runs on a constant-velocity prediction of the
keyframe pose, device poses drain to the host in batches of
``pose_drain_interval`` frames (always for frames <= 2), and plans are
memoized on the rounded relative transforms.  The steady state is three
calls, :func:`track`, :func:`propagate_step` and :func:`update`.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from tadataka_torch.camera import CameraModel
from tadataka_torch.core.pose import Pose
from tadataka_torch.core.rounding import as_divisor, matmul_small
from tadataka_torch.core.transforms import inv_motion_matrix, motion_matrix
from tadataka_torch.dataset.image_io import rgb2gray
from tadataka_torch.device import resolve_device
from tadataka_torch.utils.timing import count, span, sync_point
from tadataka_torch.vo.dvo import estimate_pose_pyramid
from tadataka_torch.vo.semi_dense import (
    SemiDenseParams, make_frame, stack_frames, propagate, increment_age,
    regularize)
from tadataka_torch.vo.semi_dense.estimator import safe_invert, update_depth
from tadataka_torch.vo.semi_dense.fast import plan_update_np, update_depth_fast
from tadataka_torch.vo.semi_dense.frame import SemiDenseFrame
from tadataka_torch.vo.semi_dense.params import DEFAULT_N_REF_SAMPLES


def plan_record(plan):
    """The planner's decision of a frame as ``metrics.log_frame`` takes
    it; ``plan`` None is the scattered estimator."""
    return dict(
        plan_path="scatter" if plan is None else plan.path,
        plan_n_planes=0 if plan is None else sum(plan.n_planes),
        plan_max_budget=0 if plan is None else max(
            (max(b) if not isinstance(b, int) else b
             for b in plan.warp_budget), default=0))


class SemiDenseVOState(NamedTuple):
    pose_wc: Pose          # camera -> world of the latest frame (on device)
    depth_map: torch.Tensor
    variance_map: torch.Tensor
    age_map: torch.Tensor
    flag_map: Optional[torch.Tensor]


def to_gray_f32(image_u8):
    """uint8 [0, 255] -> float32 [0, 1], a true quotient on every device."""
    image = image_u8.to(torch.float32)
    return image / as_divisor(255.0, image)


def prepare_image(frame, device):
    """Host gray conversion + uint8 quantization of a Frame or a raw
    image, then to ``device`` (uint8)."""
    image = frame.image if hasattr(frame, "image") else frame
    if isinstance(image, torch.Tensor):
        image = image.detach().cpu().numpy()
    gray = rgb2gray(image)
    u8 = np.clip(np.round(gray * 255.0), 0, 255).astype(np.uint8)
    with sync_point("sync.sd.image_upload"):
        return torch.from_numpy(u8).to(device)


def track(camera_model, I0, D0, V0, I1, n_levels):
    """DVO pose of frame 1 against frame 0's depth map, weighted by the
    inverse variance; returns T10 (4, 4)."""
    eye = torch.eye(3, dtype=torch.float32, device=I0.device)
    zero = torch.zeros(3, dtype=torch.float32, device=I0.device)
    R10, t10 = estimate_pose_pyramid(
        camera_model, camera_model, I0, D0, I1, safe_invert(V0), eye, zero,
        n_levels, 20, 1.5, "map", "ic")
    return motion_matrix(R10, t10)


def propagate_step(cam, T10, D0, V0, age0, default_depth, default_variance,
                   uncertainty_bias):
    """Age increment + hypothesis propagation; returns (d1, v1, age1)."""
    age1 = increment_age(age0, cam, cam, T10, D0)
    d1, v1 = propagate(T10, cam, cam, D0, V0, default_depth,
                       default_variance, uncertainty_bias)
    return d1, v1, age1


def update(cam, params, image, T_wk, ref_frames, age1, d1, v1, plan,
           regularize_depth, fuse_prior,
           n_ref_samples=DEFAULT_N_REF_SAMPLES):
    """Depth update against the refframe history (+ 3x3 regularization):
    the planned update, or the scattered estimator when ``plan`` is None.
    Returns (depth, variance, flags)."""
    keyframe = make_frame(cam, image, T_wk)
    refs = stack_frames(ref_frames)
    age_c = torch.clamp(age1, 0, refs.image.shape[0])
    with span("sd.sweep"):
        if plan is None:
            d2, v2, flags = update_depth(keyframe, refs, age_c, d1, v1,
                                         params, n_ref_samples=n_ref_samples,
                                         fuse_prior=fuse_prior)
        else:
            d2, v2, flags = update_depth_fast(keyframe, refs, age_c, d1, v1,
                                              params, plan=plan,
                                              fuse_prior=fuse_prior)
    if regularize_depth:
        with span("sd.regularize"):
            d2 = regularize(d2, v2, flags)
    return d2, v2, flags


class SemiDenseVO:
    def __init__(self, camera_params, params: SemiDenseParams = None,
                 default_depth=200.0, default_variance=100.0,
                 uncertainty_bias=1.0, depth_range=(60.0, 1000.0),
                 history_size=8, n_ref_samples=DEFAULT_N_REF_SAMPLES,
                 n_coarse_to_fine=5, regularize_depth=True,
                 initial_pose_fn=None, seed=0, depth_update="fast",
                 metrics=None, initial_depth_map=None,
                 initial_variance_map=None, fuse_prior=True, device="cuda"):
        """``camera_params``: a CameraParameters (moved to ``device``).
        ``initial_pose_fn(image0, image1) -> Pose`` optionally supplies the
        bootstrap pose of the second frame (T10, on ``device``).
        ``depth_update``: "fast" plans each frame's update (the
        homography or the rectified sweep, or the scattered estimator);
        "scatter" runs the scattered estimator, with ``n_ref_samples``
        samples per epipolar line, on every frame.
        ``metrics``: any object with ``log_frame(frame_index, **values)``;
        every frame logs the planner's decision.
        ``fuse_prior``: precision-weighted fusion of each new observation
        with the prior hypothesis (the LSD-SLAM depth filter).
        Without ``initial_depth_map`` the map starts uniform-random in
        ``depth_range`` from numpy ``default_rng(seed)``, the same draw as
        the JAX app.
        ``device``: where the step runs, the card unless the caller asks
        for "cpu"; raises if it names CUDA and there is none."""
        if depth_update not in ("fast", "scatter"):
            raise ValueError(f"depth_update={depth_update!r}: expected "
                             "'fast' or 'scatter'")
        self.device = resolve_device(device)
        self.camera_params = type(camera_params)(
            *(x.to(self.device) for x in camera_params))
        if params is None:
            params = SemiDenseParams.create(
                depth_range[0], depth_range[1], geo_coeff=0.01,
                photo_coeff=0.01, ref_step_size=0.01, min_gradient=0.2)
        self.params = SemiDenseParams(*(x.to(self.device) for x in params))
        self.depth_range = depth_range
        self.default_depth = default_depth
        self.default_variance = default_variance
        self.uncertainty_bias = uncertainty_bias
        self.history_size = history_size
        self.n_ref_samples = n_ref_samples
        self.n_coarse_to_fine = n_coarse_to_fine
        self.regularize_depth = regularize_depth
        self.fuse_prior = fuse_prior
        self.initial_pose_fn = initial_pose_fn
        self.initial_depth_map = initial_depth_map
        self.initial_variance_map = initial_variance_map
        self.seed = seed
        self.depth_update = depth_update
        self.metrics = metrics
        self._camera_model = CameraModel.create(self.camera_params)

        # planner constants, read once
        self._q0 = float(self.params.min_inv_depth)
        self._q1 = float(self.params.max_inv_depth)
        self._focal_np = self.camera_params.focal_length.cpu().numpy() \
            .astype(np.float64)
        self._offset_np = self.camera_params.offset.cpu().numpy() \
            .astype(np.float64)

        self.refframes = []            # device SemiDenseFrames
        self._ref_Ts_host = []         # host 4x4 poses of the refframes
        self.state: Optional[SemiDenseVOState] = None
        self._prev_image = None
        self._image_shape = None

        # host pose chain: exact but lagged (see the module docstring)
        self._pose_wc_host = np.eye(4)
        self._T10_host = np.eye(4)
        self._pending = []             # [(frame_id, T10 device tensor)]
        self._frame_id = 0
        self._ref_ids = []
        self.pose_drain_interval = 4
        self._prepared = {}
        self._plan_cache = {}

    # --------------------------------------------------- host pose chain

    def _advance_pose_chain(self, force=False):
        """Fold pending T10s into the host pose chain and correct the
        refframe poses that were pushed as predictions."""
        if not self._pending:
            return
        if not force and len(self._pending) < self.pose_drain_interval:
            return
        with span("sd.drain"):
            for fid, T10_dev in self._pending:
                with sync_point("sync.sd.drain"):
                    T10 = T10_dev.cpu()
                self._T10_host = T10.numpy().astype(np.float64)
                self._pose_wc_host = (
                    self._pose_wc_host @ np.linalg.inv(self._T10_host))
                if fid in self._ref_ids:
                    self._ref_Ts_host[self._ref_ids.index(fid)] = \
                        self._pose_wc_host
            self._pending = []

    def _plan(self, key_T_pred):
        """Plan the update from the host estimate of the keyframe pose,
        memoized on the rounded relative transforms."""
        with span("sd.plan"):
            n = min(len(self._ref_Ts_host), self.history_size)
            ref_Ts = np.stack(self._ref_Ts_host[-n:])
            rels = np.stack([np.linalg.inv(T) @ key_T_pred for T in ref_Ts])
            key = (n, tuple(np.round(rels[:, :3, :].ravel(), 3)))
            hit = self._plan_cache.get(key)
            if hit is not None:
                count("plan.hit")
                return hit
            count("plan.miss")
            f = np.broadcast_to(self._focal_np, (n, 2))
            c = np.broadcast_to(self._offset_np, (n, 2))
            plan = plan_update_np(key_T_pred, self._focal_np,
                                  self._offset_np, self._image_shape, ref_Ts,
                                  f, c, self._q0, self._q1)
            self._plan_cache[key] = plan
            return plan

    # ---------------------------------------------------------- per frame

    def prefetch(self, frame):
        """Prepare this frame's image now; a later ``estimate(frame)``
        picks it up."""
        self._prepared[id(frame)] = prepare_image(frame, self.device)

    def estimate(self, frame):
        """Process a frame (a Frame or a raw image).  Returns the state."""
        with span("sd.estimate", frame=self._frame_id):
            with span("sd.prepare"):
                image_u8 = self._prepared.pop(id(frame), None)
                if image_u8 is None:
                    image_u8 = prepare_image(frame, self.device)
            if self.state is None:
                return self._initialize(image_u8)
            return self._step(image_u8)

    def _step(self, image_u8):
        """A frame past the first: track, propagate, plan, update."""
        prev = self.state
        # early frames force-drain: until the first real T10 lands the
        # constant-velocity prediction is the identity
        self._advance_pose_chain(force=self._frame_id <= 2)
        image = to_gray_f32(image_u8)
        cam = self.camera_params
        bootstrap = (len(self.refframes) == 1
                     and self.initial_pose_fn is not None)
        if bootstrap:
            pose10 = self.initial_pose_fn(self._prev_image, image)
            with sync_point("sync.sd.bootstrap_pose"):
                T10 = pose10.T.to(device=self.device, dtype=torch.float32)
            self._T10_host = pose10.T.detach().cpu().numpy().astype(
                np.float64)
            self._pose_wc_host = (
                self._pose_wc_host @ np.linalg.inv(self._T10_host))
            push_T_host = self._pose_wc_host               # exact
        else:
            with span("sd.track"):
                T10 = track(self._camera_model, self._prev_image,
                            prev.depth_map, prev.variance_map, image,
                            self.n_coarse_to_fine)
            # constant-velocity prediction over the undrained frames
            inv_T = np.linalg.inv(self._T10_host)
            push_T_host = self._pose_wc_host.copy()
            for _ in range(len(self._pending) + 1):
                push_T_host = push_T_host @ inv_T
        T_wk = matmul_small(prev.pose_wc.T, inv_motion_matrix(T10))
        with span("sd.propagate"):
            depth1, variance1, age1 = propagate_step(
                cam, T10, prev.depth_map, prev.variance_map, prev.age_map,
                self.default_depth, self.default_variance,
                self.uncertainty_bias)
        plan = (self._plan(push_T_host) if self.depth_update == "fast"
                else None)
        refs = tuple(self.refframes[-self.history_size:])
        with span("sd.update"):
            depth1, variance1, flags = update(
                cam, self.params, image, T_wk, refs, age1, depth1,
                variance1, plan, self.regularize_depth, self.fuse_prior,
                self.n_ref_samples)
        if not bootstrap:
            self._pending.append((self._frame_id, T10))

        if self.metrics is not None:
            self.metrics.log_frame(self._frame_id, **plan_record(plan))
        with span("sd.push"):
            self._push_refframe(
                SemiDenseFrame(cam.focal_length, cam.offset, image, T_wk),
                push_T_host)
            self.state = SemiDenseVOState(Pose.from_matrix(T_wk), depth1,
                                          variance1, age1, flags)
        self._prev_image = image
        return self.state

    def _initialize(self, image_u8):
        image = to_gray_f32(image_u8)
        H, W = image.shape
        self._image_shape = (H, W)
        rng = np.random.default_rng(self.seed)
        if self.initial_depth_map is not None:
            depth = torch.as_tensor(self.initial_depth_map,
                                    dtype=torch.float32, device=self.device)
        else:
            depth = torch.from_numpy(
                rng.uniform(*self.depth_range, (H, W)).astype(np.float32))
            with sync_point("sync.sd.initial_map"):
                depth = depth.to(self.device)
        if self.initial_variance_map is not None:
            variance = torch.as_tensor(self.initial_variance_map,
                                       dtype=torch.float32,
                                       device=self.device)
        else:
            variance = self.default_variance * torch.ones(
                (H, W), dtype=torch.float32, device=self.device)
        age = torch.zeros((H, W), dtype=torch.int32, device=self.device)
        pose_wc = Pose.identity(device=self.device)
        self._push_refframe(make_frame(self.camera_params, image, pose_wc.T),
                            np.eye(4))
        self.state = SemiDenseVOState(pose_wc, depth, variance, age, None)
        self._prev_image = image
        return self.state

    def _push_refframe(self, keyframe, T_host):
        self.refframes.append(keyframe)
        self._ref_Ts_host.append(np.asarray(T_host, np.float64))
        self._ref_ids.append(self._frame_id)
        self._frame_id += 1
        if len(self.refframes) > self.history_size:
            self.refframes.pop(0)
            self._ref_Ts_host.pop(0)
            self._ref_ids.pop(0)

    @property
    def pose_wc_host(self):
        """Latest exact host pose (lags the device until :meth:`finish`)."""
        return self._pose_wc_host

    def finish(self):
        """Drain all pending poses (one device sync); returns the final
        exact host pose."""
        self._advance_pose_chain(force=True)
        return self._pose_wc_host
