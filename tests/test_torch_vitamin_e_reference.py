"""The port's VitaminEVO against the benchmark's plain reference
(``bench_port/reference/vitamin_e.py``) on the CPU, at 120x160: the
``ve-fr1-forward`` cell's scene and motion with the image and the
intrinsics cut by 4 (BRIEF's patch cut to 24 pixels to fit), driven
frame by frame as the benchmark drives it (``drive._step``: the
snapshot before the frame, the outputs and the port's probes of the
flow and the RANSAC choices after it), over the start frames (the
extrema, the bootstrap, the first PnP) and two more.  The check's
numbers stay within the configuration's limits on two seeds, and a planted fault in the program is caught by
them: no drift regularizer in the climb (``lambda_`` 0), the extrema
above the 90th percentile, no keypoints spawned in the new area, the
pose moved by 1 px at the image's centre, PnP's draw replaced by the
generator's next one, PnP's inlier test before the refinement loosened
to twice its threshold, the essential matrix's RANSAC threshold
doubled, EPnP without its beta case N=2, and every third triangulated
point moved 5% away from the world's origin."""

import math

import pytest
import torch

from bench_port.harness import drive, spec
from bench_port.harness.record import Recorder
from bench_port.harness.traffic import (
    HostFrame, Loop, camera_model, draw, load_mix, loop_poses, pixel_rays,
    render, texture_of)
from bench_port.reference.port.core.pose import Pose
from bench_port.tests.small import small

CELL = "ve-fr1-forward"
N_FRAMES = 5         # the extrema, the bootstrap, the first PnP, 2 more
SEEDS = (2**31 + 101, 7)


def cell_config():
    bench = spec.load_benchmark()
    _, entry = spec.cell(bench, CELL)
    config = small(spec.load_config(entry))
    config["app_args"] = dict(config["app_args"], patch_size=24)
    return config


def first_frames(config, seed, n):
    """The replay's first ``n`` frames of the cell's loop (as
    ``traffic.make_loop`` renders them, the rest of the period left
    out)."""
    mix = load_mix(spec.cell(spec.load_benchmark(), CELL)[0]["traffic"])
    shape = tuple(config["image_shape"])
    rays = pixel_rays(camera_model(config), shape, "cpu")
    planes = [tuple(map(tuple, p)) for p in config["planes"]]
    phase = tuple(float(x) for x in mix["texture_phase"])
    poses = loop_poses(mix)
    start = draw(seed, mix)
    frames = []
    for k in range(n):
        T = poses[(start + k) % len(poses)]
        pose = Pose(torch.as_tensor(T[:3, :3], dtype=torch.float32),
                    torch.as_tensor(T[:3, 3], dtype=torch.float32))
        image, _ = render(rays, pose, shape, planes, phase,
                          texture_of(config))
        u8 = torch.clamp(image * 255.0, 0, 255).to(torch.uint8)
        frames.append(HostFrame(u8[:, :, None].expand(*shape, 3).numpy(),
                                None, T))
    return Loop(frames, 0, phase)


@pytest.fixture(scope="module", params=SEEDS)
def scene(request):
    config = cell_config()
    return config, first_frames(config, request.param, N_FRAMES)


def checked(config, loop, program_config=None):
    """The check's numbers of the program (built from ``program_config``,
    the cell's by default) over the loop's frames, every frame
    sampled."""
    driver = spec.app_driver(config)
    system = driver.System(program_config or config, loop, 0,
                           torch.device("cpu"))
    rec = Recorder("cpu", False)
    system.instrument(rec)
    try:
        for k in range(len(loop.frames)):
            _, _, raised = drive._step(system, rec, loop, k, True)
            assert raised is None, raised
    finally:
        rec.restore()
    return system.check(rec.captures, loop, config, 0, torch.device("cpu"))


def caught(config, numbers):
    return any(v > config["limits"][name] for name, v in numbers.items())


def test_the_port_is_within_the_limits(scene):
    config, loop = scene
    numbers = checked(config, loop)
    assert set(numbers) == set(config["limits"])
    for name, value in numbers.items():
        assert value <= config["limits"][name], (name, numbers)


def _program_argument(name, value):
    def fault(monkeypatch, config):
        return dict(config, app_args=dict(config["app_args"],
                                          **{name: value}))
    return fault


def _no_spawn(monkeypatch, config):
    import tadataka_torch.vo.vitamin_e as vit
    real = vit._new_area

    def new_area(*args):
        kps, keep = real(*args)
        return kps, torch.zeros_like(keep)
    monkeypatch.setattr(vit, "_new_area", new_area)


def _pose_moved(monkeypatch, config):
    """The localized pose turned about y by 1 px at the image's
    centre."""
    import tadataka_torch.vo.vitamin_e as vit
    from tadataka_torch.core.pose import Pose as PortPose
    real = vit.VitaminEVO._localize
    a = math.atan(1.0 / config["camera"]["fx"])
    turn = torch.tensor([[math.cos(a), 0.0, math.sin(a)], [0.0, 1.0, 0.0],
                         [-math.sin(a), 0.0, math.cos(a)]])

    def localize(self, kp1):
        pose = real(self, kp1)
        return None if pose is None else PortPose(turn @ pose.R,
                                                  turn @ pose.t)
    monkeypatch.setattr(vit.VitaminEVO, "_localize", localize)


def _draw_replaced(monkeypatch, config):
    import tadataka_torch.pose_estimation.pnp as pnp
    real = pnp.uniform_draws

    def uniform_draws(rng, site, shape, device):
        real(rng, site, shape, device)
        return real(rng, site, shape, device)
    monkeypatch.setattr(pnp, "uniform_draws", uniform_draws)


def _pnp_inliers_loose(monkeypatch, config):
    """PnP's test of the winning hypothesis's inliers (and of the
    refined pose's) at twice its threshold; the trials' counts as they
    are."""
    import tadataka_torch.pose_estimation.pnp as pnp
    real = pnp._reprojection_errors

    def errors(R, t, points, keypoints):
        err = real(R, t, points, keypoints)
        return err / 2.0 if R.dim() == 2 else err
    monkeypatch.setattr(pnp, "_reprojection_errors", errors)


def _essential_threshold_loose(monkeypatch, config):
    import tadataka_torch.vo.vitamin_e as vit
    real = vit.estimate_pose_change

    def estimate_pose_change(*args, **kwargs):
        return real(*args, residual_threshold=0.004, **kwargs)
    monkeypatch.setattr(vit, "estimate_pose_change", estimate_pose_change)


def _epnp_n1_only(monkeypatch, config):
    """EPnP without its beta case N=2: each layout's second candidate is
    its first."""
    import tadataka_torch.pose_estimation.epnp as epnp
    monkeypatch.setattr(epnp, "_beta_n2", lambda b, v1, v2: v1)


def _triangulation_third_off(monkeypatch, config):
    import tadataka_torch.vo.vitamin_e as vit
    real = vit.pairwise_triangulation

    def pairwise_triangulation(*args):
        points, depths = real(*args)
        scale = torch.ones(len(points), 1, dtype=points.dtype)
        scale[::3] = 1.05
        return points * scale.to(points.device), depths
    monkeypatch.setattr(vit, "pairwise_triangulation",
                        pairwise_triangulation)


# each fault and the frames it needs: the extrema show on frame 0, the
# climb on frame 1, PnP on frame 2, a spawn on frames 2-3 of this seed
FAULTS = {
    "lambda_0": (_program_argument("lambda_", 0.0), 2),
    "percentile_90": (_program_argument("percentile", 90.0), 1),
    "no_spawn": (_no_spawn, 4),
    "pose_moved_1px": (_pose_moved, 3),
    "pnp_draw_replaced": (_draw_replaced, 3),
    "pnp_inliers_loose": (_pnp_inliers_loose, 3),
    "essential_threshold_loose": (_essential_threshold_loose, 2),
    "epnp_n1_only": (_epnp_n1_only, 3),
    "triangulation_third_off": (_triangulation_third_off, 2),
}


@pytest.fixture(scope="module")
def fault_scene():
    config = cell_config()
    return config, first_frames(config, SEEDS[0], 4)


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_planted_fault_is_caught(monkeypatch, fault_scene, fault):
    config, loop = fault_scene
    plant, n_frames = FAULTS[fault]
    program_config = plant(monkeypatch, config)
    numbers = checked(config, loop._replace(frames=loop.frames[:n_frames]),
                      program_config)
    assert caught(config, numbers), sorted(numbers.items())


# ------------------------------------------------------ float32's ties

def _tracks(monkeypatch, curv, ids, coords, shift, settle):
    """The reference's tracks of ``ids`` at ``coords`` moved by the flow
    (0, ``shift``) over the curvature map ``curv``, ties settled by
    ``settle``."""
    from types import SimpleNamespace
    import numpy as np
    from bench_port.reference import plain_features as pf
    from bench_port.reference import vitamin_e as ve
    monkeypatch.setattr(pf, "curvature", lambda image: curv)
    prev = SimpleNamespace(ids=np.asarray(ids, np.int64),
                           coords=np.asarray(coords, np.float32))
    M = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, shift], [0.0, 0.0, 1.0]])
    return ve.track(prev, torch.zeros(curv.shape), M, {"lambda_": 0.5},
                    settle)


def _side(ids, coords):
    import numpy as np
    return np.asarray(ids, np.int64), np.asarray(coords, np.float32)


def _gap(judged, ref):
    from bench_port.reference import vitamin_e as ve
    return ve.track_gap_pct(judged, ref)


# a valley between rows 10 and 11: a climb from row 10 runs to the top,
# one from row 11 to the bottom
VALLEY = (torch.arange(20.0)[:, None] - 10.5).pow(2).expand(20, 10)


@pytest.mark.parametrize("shift, judged_row, agrees", [
    (0.5, 0.0, True),     # the start 10.5 is a tie: either rounding
    (0.5, 19.0, True),
    (0.5, 10.0, False),   # a row that neither rounding reaches
    (0.4, 19.0, False),   # 10.4 is no tie: it rounds to row 10
])
def test_a_start_at_a_half_pixel_takes_the_judged_sides_rounding(
        monkeypatch, shift, judged_row, agrees):
    judged = _side([0], [[5.0, judged_row]])
    ref = _tracks(monkeypatch, VALLEY.contiguous(), [0], [[5.0, 10.0]],
                  shift, judged)
    assert (_gap(judged, ref) == 0.0) == agrees, ref


@pytest.mark.parametrize("shift, spawned, agrees", [
    (0.0004, True, True),   # the back-projection -0.0004 is a tie
    (0.0004, False, True),
    (0.01, False, False),   # -0.01 lies outside: the extremum spawns
    (0.01, True, True),
])
def test_a_back_projection_at_the_border_takes_the_judged_sides_spawn(
        monkeypatch, shift, spawned, agrees):
    curv = torch.zeros(20, 10)
    curv[0, 3] = 1.0         # the one extremum, on the top row
    judged = (_side([0, 1], [[8.0, 15.0], [3.0, 0.0]]) if spawned else
              _side([0], [[8.0, 15.0]]))
    ref = _tracks(monkeypatch, curv, [0], [[8.0, 15.0]], shift, judged)
    assert (_gap(judged, ref) == 0.0) == agrees, ref
