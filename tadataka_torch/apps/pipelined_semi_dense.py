"""Pipelined semi-dense VO: the tracker and the mapper one frame apart
(counterpart of ``tadataka_tpu/apps/pipelined_semi_dense.py``).

Two stages, on the card each on its own CUDA stream (the streams take
the place of the JAX app's two devices):

  tracker: DVO against the newest completed map, and pose composition
  mapper:  age increment, propagation, the planned depth update and
           the 3x3 regularization

The mapper runs one frame behind: ``estimate(t)`` issues track(t),
which reads the newest completed map (frame t-2's), then map(t-1),
which takes track(t-1)'s pose from the previous call.  Neither waits on
the other's work of this frame.  ``state`` therefore lags the pose by
one frame; :meth:`flush_map` completes the last frame's map.

Stream discipline: a stage that reads what the other made first waits
on an event the producing stream recorded, and every tensor made on one
stream and read on the other is marked with ``Tensor.record_stream`` so
the caching allocator does not hand its memory out again under the
reader.  The caller's stream waits on the mapper before it gets a
state.  DVO's per-iteration host reads synchronize the tracker's stream
only.  On the CPU the stages run in program order.

The stages are the port's own (``track``, ``propagate_step`` and
``update`` of ``apps/semi_dense_vo.py``), in the same plain forms as
the port's ``SemiDenseVO``: ``propagate`` + ``increment_age`` in place of
the JAX app's tap-grid ``propagate_tent``, and DVO over every pixel
(the JAX app's ``dvo_sample_budget`` is not ported).  The host pose
chain and the planner are the JAX app's: poses drain in batches of
``pose_drain_interval`` (always for frames <= 2), and the update is
planned from a constant-velocity prediction of the keyframe pose.
"""

from contextlib import nullcontext
from typing import Optional

import numpy as np
import torch

from tadataka_torch.apps.semi_dense_vo import (
    SemiDenseVOState, plan_record, propagate_step, track, update)
from tadataka_torch.camera import CameraModel, CameraParameters
from tadataka_torch.core.pose import Pose
from tadataka_torch.core.rounding import matmul_small
from tadataka_torch.core.transforms import inv_motion_matrix
from tadataka_torch.dataset.image_io import rgb2gray
from tadataka_torch.device import resolve_device
from tadataka_torch.vo.semi_dense import SemiDenseParams
from tadataka_torch.vo.semi_dense.fast import plan_update_np
from tadataka_torch.vo.semi_dense.frame import SemiDenseFrame


# the same fields as SemiDenseVO's state
PipelinedSemiDenseVOState = SemiDenseVOState


class _Stage:
    """A stage's device and, on the card, its own stream there."""

    def __init__(self, device):
        self.device = device
        self.stream = None
        if device.type == "cuda":
            self.stream = torch.cuda.Stream(device)
            # what the caller's stream has issued (the parameters moved
            # to the card) comes first
            self.stream.wait_stream(torch.cuda.current_stream(device))

    def context(self):
        """Issue this stage's work on its stream."""
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else nullcontext())

    def upload(self, host_tensor):
        """A host tensor on this stage's device.  To the card it goes from
        pinned memory without a wait, as a blocking copy would make the
        host wait for everything issued on this stream."""
        if self.stream is None:
            return host_tensor.to(self.device)
        with torch.cuda.stream(self.stream):
            return host_tensor.pin_memory().to(self.device,
                                               non_blocking=True)

    def record(self):
        """An event after the work issued so far (None on the CPU)."""
        if self.stream is None:
            return None
        event = torch.cuda.Event()
        event.record(self.stream)
        return event

    def receive(self, event, *tensors):
        """``tensors``, made on the other stage's stream up to ``event``,
        for this stage: its stream waits on the event, and each tensor is
        kept alive for this stream."""
        if self.stream is not None:
            self.stream.wait_event(event)
            for t in tensors:
                t.record_stream(self.stream)
        return tensors


def _hand_over(event, tensors):
    """Make the caller's current stream wait on ``event`` and keep
    ``tensors`` alive for it (nothing on the CPU)."""
    if event is None:
        return
    stream = torch.cuda.current_stream(tensors[0].device)
    stream.wait_event(event)
    for t in tensors:
        t.record_stream(stream)


def map_stage(cam, params, image, T10, T_wk, ref_frames, age0, D0, V0, plan,
              default_depth, default_variance, uncertainty_bias,
              regularize_depth, fuse_prior):
    """The mapper's program: age + propagation + the planned update +
    regularization.  Returns (age1, depth, variance, flags)."""
    d1, v1, age1 = propagate_step(cam, T10, D0, V0, age0, default_depth,
                                  default_variance, uncertainty_bias)
    d2, v2, flags = update(cam, params, image, T_wk, ref_frames, age1, d1,
                           v1, plan, regularize_depth, fuse_prior)
    return age1, d2, v2, flags


class PipelinedSemiDenseVO:
    """Tracker / mapper pipeline (see the module docstring).

    ``devices``: (tracker, mapper), the card for both unless the caller
    asks for the CPU; raises if either names CUDA and there is none.
    Both name one device: on a card each stage gets its own stream
    there (stages on two devices would need copies between them, which
    this app does not make).
    ``metrics``: any object with ``log_frame(frame_index, **values)``;
    every mapped frame logs the planner's decision, as in SemiDenseVO."""

    def __init__(self, camera_params: CameraParameters,
                 params: SemiDenseParams = None,
                 default_depth=200.0, default_variance=100.0,
                 uncertainty_bias=1.0, depth_range=(60.0, 1000.0),
                 history_size=4, n_coarse_to_fine=5,
                 regularize_depth=True, devices=("cuda", "cuda"), seed=0,
                 initial_pose_fn=None, fuse_prior=True, metrics=None):
        dev_track, dev_map = (resolve_device(d) for d in devices)
        if dev_track != dev_map:
            raise ValueError(f"devices={devices!r}: both stages on one "
                             "device (two streams of one card, or the CPU)")
        if params is None:
            params = SemiDenseParams.create(
                depth_range[0], depth_range[1], geo_coeff=0.01,
                photo_coeff=0.01, ref_step_size=0.01, min_gradient=0.2)
        self.depth_range = depth_range
        self.default_depth = default_depth
        self.default_variance = default_variance
        self.uncertainty_bias = uncertainty_bias
        self.history_size = history_size
        self.n_coarse_to_fine = n_coarse_to_fine
        self.regularize_depth = regularize_depth
        self.fuse_prior = fuse_prior
        self.initial_pose_fn = initial_pose_fn
        self.seed = seed
        self.metrics = metrics

        self._cam_m = CameraParameters(*(x.to(dev_map)
                                         for x in camera_params))
        self._params_m = SemiDenseParams(*(x.to(dev_map) for x in params))
        self._cm_t = CameraModel.create(CameraParameters(
            *(x.to(dev_track) for x in camera_params)))
        self._tracker = _Stage(dev_track)
        self._mapper = _Stage(dev_map)

        self._q0 = float(params.min_inv_depth)
        self._q1 = float(params.max_inv_depth)
        self._focal_np = camera_params.focal_length.cpu().numpy().astype(
            np.float64)
        self._offset_np = camera_params.offset.cpu().numpy().astype(
            np.float64)

        self.refframes = []            # on the mapper's device
        self._ref_Ts_host = []
        self.state: Optional[PipelinedSemiDenseVOState] = None
        self._state_event = None       # the mapper's, after ``state``
        self._prev_image_t = None      # the tracker's copies
        self._track_map = None         # (depth, variance)
        self._pose_t = None            # T_wk of the last tracked frame
        self._image_shape = None
        self._pose_wc_host = np.eye(4)
        self._T10_host = np.eye(4)
        self._pending = []             # [(frame id, T10 on the tracker)]
        self.pose_drain_interval = 4
        self._frame_id = 0
        self._track_frame_id = 0
        self._pending_map = None
        self._ref_ids = []

    @property
    def devices(self):
        return self._tracker.device, self._mapper.device

    # --------------------------------------------------------- per frame

    def estimate(self, frame):
        """Track this frame and map the previous one; returns the state
        of the previous frame (the map lags the pose by one frame)."""
        image = frame.image if hasattr(frame, "image") else frame
        if isinstance(image, torch.Tensor):
            image = image.detach().cpu().numpy()
        gray = torch.from_numpy(np.asarray(rgb2gray(image), np.float32))
        if self.state is None:
            return self._initialize(gray)

        self._advance_pose_chain(force=self._track_frame_id <= 2)
        self._track_frame_id += 1

        # the tracker: frame t against the newest completed map
        I1_t = self._tracker.upload(gray)
        with self._tracker.context():
            if len(self.refframes) == 1 and self.initial_pose_fn is not None:
                # scale-fixing bootstrap, as in SemiDenseVO
                pose10 = self.initial_pose_fn(self._prev_image_t, I1_t)
                T10_host = pose10.T.detach().cpu().numpy().astype(np.float64)
                T_wk_host = self._pose_wc_host @ np.linalg.inv(T10_host)
                T10 = torch.tensor(T10_host, dtype=torch.float32,
                                   device=self._tracker.device)
                T_wk = torch.tensor(T_wk_host, dtype=torch.float32,
                                    device=self._tracker.device)
                self._T10_host = T10_host
                self._pose_wc_host = T_wk_host
            else:
                D_t, V_t = self._track_map
                T10 = track(self._cm_t, self._prev_image_t, D_t, V_t, I1_t,
                            self.n_coarse_to_fine)
                T_wk = matmul_small(self._pose_t, inv_motion_matrix(T10))
                self._pending.append((self._track_frame_id, T10))
            self._pose_t = T_wk
        track_event = self._tracker.record()

        # the mapper: the previous frame, whose pose is already issued
        self._dispatch_pending_map()

        # this frame's mapper inputs, for the next call
        inv_T = np.linalg.inv(self._T10_host)
        push_T_host = self._pose_wc_host.copy()
        for _ in range(len(self._pending)):
            push_T_host = push_T_host @ inv_T
        image_m = self._mapper.upload(gray)
        self._pending_map = (image_m, T10, T_wk, push_T_host, track_event)
        self._prev_image_t = I1_t
        return self._published()

    def _dispatch_pending_map(self):
        """Issue the mapper stage of the queued frame (if any): the new
        state, refframe and tracker map."""
        if self._pending_map is None:
            return
        image_m, T10, T_wk, push_T_host, track_event = self._pending_map
        self._pending_map = None
        prev = self.state
        plan = self._plan(push_T_host)
        refs = tuple(self.refframes[-self.history_size:])
        T10_m, T_wk_m = self._mapper.receive(track_event, T10, T_wk)
        with self._mapper.context():
            age1, d2, v2, flags = map_stage(
                self._cam_m, self._params_m, image_m, T10_m, T_wk_m, refs,
                prev.age_map, prev.depth_map, prev.variance_map, plan,
                self.default_depth, self.default_variance,
                self.uncertainty_bias, self.regularize_depth,
                self.fuse_prior)
            pose = Pose.from_matrix(T_wk_m)
        map_event = self._mapper.record()
        if self.metrics is not None:
            self.metrics.log_frame(self._frame_id, **plan_record(plan))
        # the completed map goes to the tracker, read two frames later
        self._track_map = self._tracker.receive(map_event, d2, v2)
        self._push_refframe(SemiDenseFrame(self._cam_m.focal_length,
                                           self._cam_m.offset, image_m,
                                           T_wk_m), push_T_host)
        self.state = PipelinedSemiDenseVOState(pose, d2, v2, age1, flags)
        self._state_event = map_event

    def _published(self):
        """``state``, safe to read on the caller's current stream."""
        s = self.state
        _hand_over(self._state_event,
                   [x for x in (s.pose_wc.R, s.pose_wc.t, s.depth_map,
                                s.variance_map, s.age_map, s.flag_map)
                    if x is not None])
        return s

    def flush_map(self):
        """Complete the last frame's mapper stage (once, after the last
        ``estimate``); returns the state of that frame."""
        self._dispatch_pending_map()
        return self._published()

    def _initialize(self, gray):
        H, W = gray.shape
        self._image_shape = (H, W)
        rng = np.random.default_rng(self.seed)
        depth = torch.from_numpy(
            rng.uniform(*self.depth_range, (H, W)).astype(np.float32))
        image_m = self._mapper.upload(gray)
        with self._mapper.context():
            dev = self._mapper.device
            depth_m = depth.to(dev)
            variance_m = self.default_variance * torch.ones(
                (H, W), dtype=torch.float32, device=dev)
            age_m = torch.zeros((H, W), dtype=torch.int32, device=dev)
            pose_wc = Pose.identity(device=dev)
            keyframe = SemiDenseFrame(self._cam_m.focal_length,
                                      self._cam_m.offset, image_m,
                                      pose_wc.T)
        self._push_refframe(keyframe, np.eye(4))
        init_event = self._mapper.record()
        self._track_map = self._tracker.receive(init_event, depth_m,
                                                variance_m)
        self._prev_image_t = self._tracker.upload(gray)
        with self._tracker.context():
            self._pose_t = torch.eye(4, dtype=torch.float32,
                                     device=self._tracker.device)
        self.state = PipelinedSemiDenseVOState(pose_wc, depth_m, variance_m,
                                               age_m, None)
        self._state_event = init_event
        return self._published()

    # ------------------------------------------------- host pose chain

    def _advance_pose_chain(self, force=False):
        """Fold pending T10s into the host pose chain (read on the
        tracker's stream, which made them) and correct the refframe
        poses that were pushed as predictions."""
        if not self._pending:
            return
        if not force and len(self._pending) < self.pose_drain_interval:
            return
        with self._tracker.context():
            for fid, T10_t in self._pending:
                self._T10_host = T10_t.cpu().numpy().astype(np.float64)
                self._pose_wc_host = (self._pose_wc_host
                                      @ np.linalg.inv(self._T10_host))
                if fid in self._ref_ids:
                    self._ref_Ts_host[self._ref_ids.index(fid)] = \
                        self._pose_wc_host
        self._pending = []

    def _plan(self, key_T_pred):
        n = min(len(self._ref_Ts_host), self.history_size)
        ref_Ts = np.stack(self._ref_Ts_host[-n:])
        f = np.broadcast_to(self._focal_np, (n, 2))
        c = np.broadcast_to(self._offset_np, (n, 2))
        return plan_update_np(key_T_pred, self._focal_np, self._offset_np,
                              self._image_shape, ref_Ts, f, c,
                              self._q0, self._q1)

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
        """Complete the last map, drain every pending pose; returns the
        final exact host pose."""
        self._dispatch_pending_map()
        self._advance_pose_chain(force=True)
        return self._pose_wc_host
