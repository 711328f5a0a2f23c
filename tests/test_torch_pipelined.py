"""The port's PipelinedSemiDenseVO against the JAX package's on the CPU,
on tests/parallel/test_pipelined.py's configuration (80x100, focal 80,
0.18 m a frame, history 4, 4 levels, the true bootstrap pose).

The JAX app (both stages on one CPU device) compiles its mapper stage
anew for every frame's plan (most of this file's time), so the two apps
are compared over the first three frames and the final flush: the
initial map, the bootstrap frame's map and one tracked frame.  As in
tests/test_torch_app.py, the JAX app runs its tap-grid propagation and
tent warps, the port the plain scatter propagation and gather warps, so
maps are compared by the share of pixels that agree and by quantiles of
the relative depth difference on pixels SUCCESS on both.  The port alone
then runs that file's five frames and passes its gates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tadataka_tpu.apps import PipelinedSemiDenseVO as JPipelined
from tadataka_tpu.camera import CameraParameters as JCameraParameters
from tadataka_tpu.core.pose import Pose as JPose
from tadataka_tpu.dataset.synthetic import multi_plane_scene
from tadataka_tpu.vo.semi_dense import SemiDenseParams as JParams

from tadataka_torch import interop
from tadataka_torch.apps import PipelinedSemiDenseVO

H, W = 80, 100
FOCAL = (80.0, 80.0)
VO_ARGS = dict(default_depth=8.0, default_variance=1.0,
               uncertainty_bias=0.01, depth_range=(2.0, 50.0),
               n_coarse_to_fine=4, history_size=4)
N_COMPARED = 3


@pytest.fixture(scope="module")
def scene():
    poses = [JPose.from_rotvec(jnp.array([0.0, 0.002 * i, 0.0]),
                               jnp.array([0.18 * i, 0.01 * i, 0.01 * i]))
             for i in range(5)]
    ds = multi_plane_scene(n_frames=5, image_shape=(H, W),
                           focal_length=FOCAL, poses=poses)
    frames = [ds[i] for i in range(5)]
    jcam = JCameraParameters.create(FOCAL, (W / 2, H / 2))
    jparams = JParams.create(2.0, 50.0, ref_step_size=0.002,
                             min_gradient=0.01)
    return frames, poses, jcam, jparams


def port_app(jcam, jparams, T10):
    pT10 = interop.pose_from_numpy(T10.R, T10.t)
    return PipelinedSemiDenseVO(
        interop.camera_from_numpy(jcam.focal_length, jcam.offset),
        params=interop.params_from_numpy(jparams), devices=("cpu", "cpu"),
        initial_pose_fn=lambda image0, image1: pT10, **VO_ARGS)


def as_numpy(x):
    if isinstance(x, tuple):
        return type(x)(*map(as_numpy, x))
    return None if x is None else np.asarray(x)


@pytest.fixture(scope="module")
def runs(scene):
    """The states after each estimate of the first N_COMPARED frames and
    after flush_map, in both apps."""
    frames, poses, jcam, jparams = scene
    images = [np.asarray(f.image) for f in frames[:N_COMPARED]]
    T10 = poses[1].inv() * poses[0]
    cpu = jax.devices()[0]
    jvo = JPipelined(jcam, params=jparams, devices=(cpu, cpu),
                     initial_pose_fn=lambda image0, image1: T10, **VO_ARGS)
    jstates = [as_numpy(jvo.estimate(image)) for image in images]
    jstates.append(as_numpy(jvo.flush_map()))
    vo = port_app(jcam, jparams, T10)
    states = [interop.to_numpy(vo.estimate(image)) for image in images]
    states.append(interop.to_numpy(vo.flush_map()))
    return states, jstates


def pose_T(state):
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = state.pose_wc.R, state.pose_wc.t
    return T


def test_pipelined_initial_state_equal(runs):
    """Until the bootstrap frame's map is done the state is the initial
    one, the same numpy draw on both sides."""
    states, jstates = runs
    for k in (0, 1):
        for name in ("depth_map", "variance_map", "age_map"):
            np.testing.assert_array_equal(getattr(states[k], name),
                                          getattr(jstates[k], name))
        assert states[k].flag_map is None and jstates[k].flag_map is None


def test_pipelined_poses(runs):
    """The bootstrap frame's pose is the given one on both sides (equal
    within 1e-6); the tracked frame's within 5e-3 (tracked against the
    same initial map: 0 measured)."""
    states, jstates = runs
    np.testing.assert_allclose(pose_T(states[2]), pose_T(jstates[2]),
                               atol=1e-6)
    np.testing.assert_allclose(pose_T(states[3]), pose_T(jstates[3]),
                               atol=5e-3)


@pytest.mark.parametrize("k", [2, 3])
def test_pipelined_maps(runs, k):
    """The maps of frames 1 and 2 (read after frame 2 and after the
    flush), with test_torch_app.py's bounds: flags and ages agree on >=
    98% of pixels; on pixels SUCCESS on both the relative depth
    difference has median <= 2e-3 and 90th percentile <= 5e-2 (measured:
    flags 1.000 / 0.990, median 5.5e-4 / 9.5e-5, 90th 1.1e-2 /
    2.6e-3)."""
    states, jstates = runs
    s, j = states[k], jstates[k]
    assert np.mean(s.flag_map == j.flag_map) >= 0.98
    assert np.mean(s.age_map == j.age_map) >= 0.98
    both = (s.flag_map == 0) & (j.flag_map == 0)
    assert both.mean() > 0.2
    rel = np.abs(s.depth_map - j.depth_map)[both] / j.depth_map[both]
    q50, q90 = np.quantile(rel, [0.5, 0.9])
    assert q50 <= 2e-3 and q90 <= 5e-2, (q50, q90)
    assert np.all(np.isfinite(s.depth_map)) and np.all(s.variance_map > 0)


def test_port_passes_the_pipelined_test_gates(scene):
    """tests/parallel/test_pipelined.py's gates on the port over its five
    frames: SUCCESS share > 0.15, median |depth - GT| < 1.5 on SUCCESS
    pixels, final x > 0.2; the map is on the mapper's device and the
    tracker's copy on the tracker's."""
    frames, poses, jcam, jparams = scene
    vo = port_app(jcam, jparams, poses[1].inv() * poses[0])
    for frame in frames:
        vo.estimate(np.asarray(frame.image))
    st = vo.flush_map()
    assert vo.devices == (torch.device("cpu"), torch.device("cpu"))
    assert st.depth_map.device == vo._track_map[0].device == vo.devices[1]
    success = (st.flag_map == 0).numpy()
    assert success.mean() > 0.15, success.mean()
    err = np.abs(st.depth_map.numpy()
                 - np.asarray(frames[4].depth_map))[success]
    assert np.median(err) < 1.5, np.median(err)
    assert vo.finish()[0, 3] > 0.2


def test_pipelined_devices(monkeypatch, scene):
    """The stages default to the card and raise without one; stages on
    two devices are refused."""
    _, poses, jcam, jparams = scene
    cam = interop.camera_from_numpy(jcam.focal_length, jcam.offset)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PipelinedSemiDenseVO(cam)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for devices in (("cpu", "cuda"), ("cuda:0", "cuda:1")):
        with pytest.raises(ValueError, match="both stages on one device"):
            PipelinedSemiDenseVO(cam, devices=devices)


def test_pipelined_metrics_log_each_mapped_frame(scene):
    """``metrics=`` gets one record a mapped frame (frames 1-4 of the
    five, the last at the flush), each the planner's decision for that
    frame as SemiDenseVO logs it, and leaves the states as they are
    without it."""
    from tadataka_torch.apps.semi_dense_vo import plan_record

    class Log:
        def __init__(self):
            self.frames = []

        def log_frame(self, frame_index, **values):
            self.frames.append((frame_index, values))

    frames, poses, jcam, jparams = scene
    T10 = poses[1].inv() * poses[0]
    states = []
    for metrics in (None, Log()):
        vo = port_app(jcam, jparams, T10)
        vo.metrics = metrics
        planned = []
        plan_fn = vo._plan
        vo._plan = lambda key_T: planned.append(plan_fn(key_T)) or planned[-1]
        for frame in frames:
            vo.estimate(np.asarray(frame.image))
        states.append(interop.to_numpy(vo.flush_map()))
    assert [k for k, _ in metrics.frames] == [1, 2, 3, 4]
    assert [v for _, v in metrics.frames] == [plan_record(p)
                                              for p in planned]
    assert all(v["plan_n_planes"] > 0 for _, v in metrics.frames)
    a, b = states
    np.testing.assert_array_equal(pose_T(a), pose_T(b))
    for name in ("depth_map", "variance_map", "age_map", "flag_map"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
