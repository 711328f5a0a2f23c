"""The stereo matcher, the block-row update and the pipelined app on the
card against the same code on the CPU, bit for bit, and the pipelined
app's stream ordering; the feature-based VO's front end (detection,
BRIEF, matching), each of its stages past matching on the same inputs,
and its poses, bit for bit; VITAMIN-E's front end, ORB and its VO.

This file imports no JAX, so it runs on a machine with a card without
``tests/conftest.py`` (which imports JAX):

    python -m pytest --noconftest tests/test_torch_cuda_slice.py -m cuda

Without a CUDA device the ``cuda`` tests skip.
"""

import numpy as np
import pytest
import torch

import tadataka_torch.apps.pipelined_semi_dense as pipelined
from tadataka_torch.apps import PipelinedSemiDenseVO
from tadataka_torch.camera import CameraModel, CameraParameters
from tadataka_torch.core.pose import Pose
from tadataka_torch.dataset import multi_plane_scene, render_plane_scene
from tadataka_torch.dataset.synthetic import MULTI_PLANES
from tadataka_torch.features.brief import extract_features
from tadataka_torch.features.matching import (
    match_descriptors, match_descriptors_guided)
from tadataka_torch.ba import schur
from tadataka_torch.metrics import absolute_trajectory_error
from tadataka_torch.vo.feature_based import FeatureBasedVO
from tadataka_torch.vo.semi_dense import (
    SemiDenseParams, make_frame, stack_frames, update_depth)
from tadataka_torch.vo.stereo import estimate_depth_from_stereo

H, W = 80, 100
FOCAL = 80.0
VO_ARGS = dict(default_depth=8.0, default_variance=1.0,
               uncertainty_bias=0.01, depth_range=(2.0, 50.0),
               n_coarse_to_fine=4, history_size=4)


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def frames(n=5):
    poses = [Pose.from_rotvec(torch.tensor([0.0, 0.002 * i, 0.0]),
                              torch.tensor([0.18 * i, 0.01 * i, 0.01 * i]))
             for i in range(n)]
    ds = multi_plane_scene(n, (H, W), (FOCAL, FOCAL), poses)
    return [ds[i] for i in range(n)]


def pipelined_states(device, sequence):
    """Every state of the pipelined app over the frames, and the flushed
    one, as CPU tensors."""
    boot = sequence[1].pose.inv() * sequence[0].pose
    vo = PipelinedSemiDenseVO(
        CameraParameters.create((FOCAL, FOCAL), (W / 2, H / 2)),
        params=SemiDenseParams.create(2.0, 50.0, ref_step_size=0.002,
                                      min_gradient=0.01),
        devices=(device, device), initial_pose_fn=lambda a, b: boot,
        **VO_ARGS)
    states = [vo.estimate(f) for f in sequence] + [vo.flush_map()]
    out = [[None if x is None else x.cpu()
            for x in (s.pose_wc.R, s.pose_wc.t, s.depth_map, s.variance_map,
                      s.age_map, s.flag_map)] for s in states]
    return out, vo


def assert_states_equal(a, b):
    for k, (sa, sb) in enumerate(zip(a, b)):
        for x, y in zip(sa, sb):
            assert (x is None and y is None) or torch.equal(x, y), k


@pytest.mark.cuda
def test_stereo_card_equals_cpu():
    """Disparity-based depth and the valid mask of a 96x160 pair at
    max_disparity 48 are bit-equal on the card and the CPU."""
    needs_card()
    params = CameraParameters.create((96.0, 96.0), (80.0, 48.0))
    cm = CameraModel.create(params)
    left, _ = render_plane_scene(cm, Pose.identity(), (96, 160),
                                 planes=MULTI_PLANES)
    right, _ = render_plane_scene(
        cm, Pose(torch.eye(3), torch.tensor([1.4, 0.0, 0.0])), (96, 160),
        planes=MULTI_PLANES)
    cpu = estimate_depth_from_stereo(params, left, right, 1.4,
                                     max_disparity=48, device="cpu")
    card = estimate_depth_from_stereo(params, left, right, 1.4,
                                      max_disparity=48)
    assert card[0].device.type == "cuda"
    for a, b in zip(cpu, card):
        assert torch.equal(a, b.cpu())
    assert cpu[1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [(0, 30), (30, 80)])
def test_update_depth_row_offset_card_equals_cpu(rows):
    """The scattered update of a block of rows, bit-equal on the card and
    the CPU."""
    needs_card()
    seq = frames(3)
    cam = CameraParameters.create((FOCAL, FOCAL), (W / 2, H / 2))
    params = SemiDenseParams.create(2.0, 50.0, ref_step_size=0.002,
                                    min_gradient=0.01)
    gen = np.random.default_rng(3)
    gt = seq[2].depth_map.numpy()
    prior = torch.from_numpy(
        (gt * gen.uniform(0.9, 1.1, gt.shape)).astype(np.float32))
    variance = torch.from_numpy(
        gen.uniform(0.002, 0.05, gt.shape).astype(np.float32))
    age = torch.from_numpy(gen.integers(0, 3, gt.shape).astype(np.int32))
    a, b = rows
    out = []
    for device in ("cpu", "cuda"):
        to = lambda x: x.to(device)
        key = make_frame(CameraParameters(*map(to, cam)), to(seq[2].image),
                         to(seq[2].pose.T))
        refs = stack_frames([make_frame(CameraParameters(*map(to, cam)),
                                        to(f.image), to(f.pose.T))
                             for f in seq[:2]])
        out.append([x.cpu() for x in update_depth(
            key, refs, to(age[a:b]), to(prior[a:b]), to(variance[a:b]),
            SemiDenseParams(*map(to, params)), row_offset=a)])
    for x, y in zip(*out):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_pipelined_card_equals_cpu():
    """Every state of the pipelined app (pose and maps) bit-equal on the
    card and the CPU over five frames; the stages ran on two streams of
    their own."""
    needs_card()
    seq = frames()
    cpu, _ = pipelined_states("cpu", seq)
    card, vo = pipelined_states("cuda", seq)
    assert_states_equal(cpu, card)
    streams = {vo._tracker.stream, vo._mapper.stream}
    assert len(streams) == 2
    assert torch.cuda.default_stream() not in streams


@pytest.mark.cuda
@pytest.mark.parametrize("slow", ["mapper", "tracker"])
def test_pipelined_waits_for_the_other_stage(monkeypatch, slow):
    """With one stage's stream held back by a spin before each of its
    programs, the other stage still reads only finished tensors: the
    states stay bit-equal to the CPU's.  A missing event wait shows here
    as a read of a map or pose not yet written."""
    needs_card()
    seq = frames()
    cpu, _ = pipelined_states("cpu", seq)
    name = "map_stage" if slow == "mapper" else "track"
    real = getattr(pipelined, name)

    def held_back(*args, **kwargs):
        torch.cuda._sleep(50_000_000)
        return real(*args, **kwargs)

    monkeypatch.setattr(pipelined, name, held_back)
    card, _ = pipelined_states("cuda", seq)
    assert_states_equal(cpu, card)


FEATURE_CONFIG = dict(window_size=8, min_matches=12, max_keypoints=512,
                      patch_size=24, fast_threshold=0.02)


def feature_frames(n=5):
    """tests/vo/test_feature_based.py's sequence: 120x160, focal 120."""
    poses = [Pose.from_rotvec(torch.tensor([0.0, 0.002 * i, 0.0]),
                              torch.tensor([0.25 * i, 0.01 * i, 0.02 * i]))
             for i in range(n)]
    ds = multi_plane_scene(n, (120, 160), (120.0, 120.0), poses)
    return [ds[i] for i in range(n)]


def fixed_draws(site, shape):
    """The same RANSAC draws on either device."""
    return np.random.default_rng(3939).random(shape, dtype=np.float32)


@pytest.mark.cuda
def test_feature_front_end_bit_equal():
    """FAST, NMS, top-k, BRIEF, normalization, Hamming, mutual-NN with the
    ratio test and the guided gate: the card gives the CPU's bits."""
    needs_card()
    seq = feature_frames(2)
    out = {}
    for device in ("cpu", "cuda"):
        feats = [extract_features(f.image.to(device), 512, 0.02, 24)
                 for f in seq]
        cm = seq[0].camera_model.to(device)
        kps = [cm.normalize(f.keypoints) for f in feats]
        m = match_descriptors(feats[0].descriptors, feats[1].descriptors,
                              feats[0].mask, feats[1].mask)
        g = match_descriptors_guided(
            feats[0].descriptors, feats[1].descriptors, feats[0].mask,
            feats[1].mask, kps[0] + 0.003, kps[1], 0.02)
        out[device] = [x.cpu() for f in feats for x in f] + [
            k.cpu() for k in kps] + [m.indices.cpu(), m.mask.cpu(),
                                     g.indices.cpu(), g.mask.cpu()]
    assert int(out["cpu"][-3].sum()) > 100
    for a, b in zip(out["cpu"], out["cuda"]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_feature_vo_card_against_cpu(tmp_path):
    """The whole VO with the same draws on both devices, on bench.py's
    bench_euroc setting (the EuRoC export at 240x320, 5 frames), on the
    card also with each next frame's extraction prefetched: every frame
    gets a pose, and both card runs give the CPU's bits."""
    from tadataka_torch.dataset import EurocDataset, export_euroc_scene
    from tadataka_torch.dataset.frame import Frame
    needs_card()
    export_euroc_scene(tmp_path, n_frames=5, image_shape=(240, 320))
    ds = EurocDataset(tmp_path)
    seq = [Frame(f.camera_model, f.pose,
                 f.image.numpy().astype(np.float32) / 255.0, None)
           for f in (ds[i][0] for i in range(5))]
    runs = {}
    for device, prefetch in (("cpu", False), ("cuda", False),
                             ("cuda", True)):
        vo = FeatureBasedVO(device=device, rng=fixed_draws,
                            fast_threshold=10.0 / 255.0, min_matches=24,
                            max_keypoints=512)
        poses = []
        for k, frame in enumerate(seq):
            if prefetch and k + 1 < len(seq):
                vo.prefetch(seq[k + 1])
            poses.append(vo.estimate(frame))
        assert all(p is not None for p in poses)
        runs[device, prefetch] = poses
    for key in (("cuda", False), ("cuda", True)):
        for a, b in zip(runs["cpu", False], runs[key]):
            assert torch.equal(a.R, b.R) and torch.equal(a.t, b.t), key


@pytest.mark.cuda
def test_feature_vo_card_on_test_sequence():
    """tests/vo/test_feature_based.py's sequence and configuration on the
    card with fixed draws: that test's gates (aligned ATE under 0.25 of
    the extent, first motion's cosine over 0.95), and the CPU's bits on
    two card runs: every value the VO probes stage by stage
    (``utils/timing.py``'s ``capture``; a failure names the first that
    parts), every pose and the map."""
    from tadataka_torch.utils.timing import capture
    needs_card()
    seq = feature_frames(5)
    gt = np.stack([f.pose.t.numpy() for f in seq])
    runs, maps, probed = [], [], []
    for device in ("cpu", "cuda", "cuda"):
        vo = FeatureBasedVO(device=device, rng=fixed_draws, **FEATURE_CONFIG)
        with capture() as values:
            runs.append([vo.estimate(f) for f in seq])
        maps.append(vo.point_dict)
        probed.append(values)
    assert all(p is not None for p in runs[0])
    for values in probed[1:]:
        assert len(values) == len(probed[0]) > 400
        for i, ((stage_, name, x), (_, _, y)) in enumerate(
                zip(probed[0], values)):
            assert np.array_equal(x, y, equal_nan=True), (i, stage_, name)
    for run, points in zip(runs[1:], maps[1:]):
        for a, b in zip(runs[0], run):
            assert torch.equal(a.R, b.R) and torch.equal(a.t, b.t)
        assert sorted(points) == sorted(maps[0])
        assert all(np.array_equal(points[k], maps[0][k]) for k in points)
    est = np.stack([p.t.numpy() for p in runs[0]]).astype(np.float64)
    extent = np.linalg.norm(gt[-1] - gt[0])
    assert float(absolute_trajectory_error(est, gt)) < 0.25 * extent
    d_est = est[1] - est[0]
    d_gt = seq[0].pose.R.numpy().T @ (gt[1] - gt[0])
    assert d_est @ d_gt / (np.linalg.norm(d_est) * np.linalg.norm(d_gt)) \
        > 0.95


def bootstrap_inputs():
    """The CPU VO's first two frames of the 120x160 sequence: the matched
    normalized keypoints (kp0, kp1) and the second pose."""
    seq = feature_frames(2)
    vo = FeatureBasedVO(device="cpu", rng=fixed_draws, **FEATURE_CONFIG)
    for f in seq:
        vo.estimate(f)
    m = vo.frame_stats["matches"][0]
    return (torch.from_numpy(vo._kp_np[0][m[:, 0]]),
            torch.from_numpy(vo._kp_np[1][m[:, 1]]), vo.poses[1])


def stage_calls():
    """Each function of the feature VO past matching, as a callable of
    the device, on inputs made once on the CPU."""
    from tadataka_torch.ba.schur import lm_solve
    from tadataka_torch.core.so3 import exp_so3, log_so3
    from tadataka_torch.core.triangulation import (
        pairwise_triangulation, two_view_triangulation)
    from tadataka_torch.pose_estimation.epipolar import estimate_pose_change
    from tadataka_torch.pose_estimation.pnp import solve_pnp_ransac
    kp0, kp1, pose1 = bootstrap_inputs()
    pose0 = Pose.identity()
    points, _ = two_view_triangulation(pose0, pose1, kp0, kp1)
    n = len(kp0)
    g = np.random.default_rng(5)
    rotvecs = torch.tensor(g.normal(0, 0.3, (64, 3)), dtype=torch.float32)
    to = lambda d, *xs: [x.to(d) for x in xs]   # noqa: E731

    def ba(d):
        params = torch.stack([torch.zeros(6), torch.cat([
            log_so3(pose1.R), pose1.t])])
        vi = torch.cat([torch.zeros(n, dtype=torch.int64),
                        torch.ones(n, dtype=torch.int64)])
        pi_ = torch.cat([torch.arange(n), torch.arange(n)])
        return lm_solve(*to(d, params, points, vi, pi_,
                            torch.cat([kp0, kp1])),
                        max_iter=10, relative_error_threshold=1e-4)

    from tadataka_torch.ba.schur import _assemble, _schur_step
    from tadataka_torch.features.ransac import (
        _eight_point, _normalize_points, sampson_distance)
    from tadataka_torch.pose_estimation.epipolar import decompose_essential
    from tadataka_torch.pose_estimation.epnp import epnp_pose
    from tadataka_torch.pose_estimation.pnp import _refine_gauss_newton
    idx = torch.from_numpy(g.integers(0, n, (32, 8)))
    F = _eight_point(kp0[idx], kp1[idx])
    E = torch.tensor(g.normal(0, 1, (3, 3)), dtype=torch.float32)
    idx5 = torch.from_numpy(g.integers(0, n, (32, 5)))
    vi = torch.from_numpy(g.integers(0, 3, 2 * n))
    pi_ = torch.cat([torch.arange(n), torch.arange(n)])
    ba_args = (torch.tensor(g.normal(0, 0.05, (3, 6)), dtype=torch.float32),
               points, vi, pi_, torch.cat([kp0, kp1]), torch.ones(2 * n))
    normal_eq = _assemble(*ba_args)
    return {
        "_normalize_points": lambda d: _normalize_points(kp0[idx].to(d)),
        "_eight_point": lambda d: _eight_point(*to(d, kp0[idx], kp1[idx])),
        "sampson_distance": lambda d: sampson_distance(
            *to(d, F[:, None], kp0, kp1)),
        "decompose_essential": lambda d: decompose_essential(E.to(d)),
        "epnp_pose": lambda d: epnp_pose(*to(d, points[idx5], kp1[idx5])),
        "_refine_gauss_newton": lambda d: _refine_gauss_newton(
            *to(d, pose1.R, pose1.t, points, kp1, torch.ones(n)), 15),
        "_assemble": lambda d: _assemble(*to(d, *ba_args)),
        "_schur_step": lambda d: _schur_step(*to(d, *normal_eq[:5]), 1e-4),
        "exp_so3": lambda d: exp_so3(rotvecs.to(d)),
        "log_so3": lambda d: log_so3(exp_so3(rotvecs).to(d)),
        "estimate_pose_change": lambda d: estimate_pose_change(
            *to(d, kp0, kp1), rng=fixed_draws),
        "two_view_triangulation": lambda d: two_view_triangulation(
            Pose(*to(d, *pose0)), Pose(*to(d, *pose1)), *to(d, kp0, kp1)),
        "pairwise_triangulation": lambda d: pairwise_triangulation(
            *to(d, pose0.R.expand(n, 3, 3), pose0.t.expand(n, 3), pose1.R,
                pose1.t, kp0, kp1)),
        "solve_pnp_ransac": lambda d: solve_pnp_ransac(
            *to(d, points, kp1, torch.ones(n, dtype=torch.bool)),
            fixed_draws),
        "lm_solve": ba,
    }


STAGE_NAMES = ("_normalize_points", "_eight_point", "sampson_distance",
               "decompose_essential", "epnp_pose", "_refine_gauss_newton",
               "_assemble", "_schur_step",
               "exp_so3", "log_so3", "estimate_pose_change",
               "two_view_triangulation", "pairwise_triangulation",
               "solve_pnp_ransac", "lm_solve")


def flat_outputs(out):
    if isinstance(out, torch.Tensor):
        return [out.cpu()]
    return [x for o in out for x in flat_outputs(o)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", STAGE_NAMES)
def test_feature_stage_card_equals_cpu(name):
    """Each stage of the feature VO past matching, fed the same inputs
    on the CPU and the card (RANSAC with the same draws), gives the same
    bits: every value it probes (``utils/timing.py``'s ``capture``) and
    its outputs.  A failure names the first value that parts."""
    from tadataka_torch.utils.timing import capture
    needs_card()
    call = stage_calls()[name]
    runs = {}
    for device in ("cpu", "cuda"):
        with capture() as values:
            out = flat_outputs(call(device))
        runs[device] = values + [("output", str(i), x.numpy())
                                 for i, x in enumerate(out)]
    a, b = runs["cpu"], runs["cuda"]
    assert len(a) == len(b), name
    for (stage_, q, x), (_, _, y) in zip(a, b):
        assert np.array_equal(x, y, equal_nan=True), (
            name, stage_, q, float(np.nanmax(np.abs(
                x.astype(np.float64) - y.astype(np.float64)))))


@pytest.mark.cuda
def test_ba_assembly_card_same_bits_every_run():
    """The normal equations on the card: the same bits on a second run
    (no atomic sum), within 1e-5 of the largest entry of the CPU's."""
    needs_card()
    g = np.random.default_rng(0)
    M, N, O = 5, 400, 1600
    args = [torch.tensor(g.normal(0, 0.05, (M, 6)), dtype=torch.float32),
            torch.tensor(g.normal(0, 1, (N, 3)) + [0, 0, 5],
                         dtype=torch.float32),
            torch.tensor(g.integers(0, M, O)), torch.tensor(
                g.integers(0, N, O)),
            torch.tensor(g.normal(0, 0.2, (O, 2)), dtype=torch.float32),
            torch.ones(O)]
    cpu = schur._assemble(*args)
    card = [schur._assemble(*(a.cuda() for a in args)) for _ in range(2)]
    for a, b, c in zip(cpu, *card):
        assert torch.equal(b, c)
        assert (b.cpu() - a).abs().max() <= 1e-5 * a.abs().max()


def vitamin_e_frames(n=4):
    """tests/vo/test_vitamin_e.py's sequence: 120x160, focal 120."""
    poses = [Pose.from_rotvec(torch.tensor([0.0, 0.003 * i, 0.0]),
                              torch.tensor([0.15 * i, 0.01 * i, 0.0]))
             for i in range(n)]
    ds = multi_plane_scene(n, (120, 160), (120.0, 120.0), poses)
    return [ds[i] for i in range(n)]


@pytest.mark.cuda
def test_vitamin_e_front_end_and_orb_bit_equal():
    """The curvature, its extrema, ORB's features and every KeypointFrame
    of track_sequence (ids and coordinates), with the same draws: the
    card gives the CPU's bits."""
    from tadataka_torch.features import Matcher
    from tadataka_torch.features.curvature import (
        compute_image_curvature, extract_curvature_extrema)
    from tadataka_torch.features.orb import extract_orb_features
    from tadataka_torch.vo.vitamin_e import track_sequence
    needs_card()
    seq = vitamin_e_frames()
    out = {}
    for device in ("cpu", "cuda"):
        images = [f.image.to(device) for f in seq]
        tensors = [compute_image_curvature(images[0])]
        tensors += list(extract_curvature_extrema(images[1], 98.0, 2048))
        tensors += list(extract_orb_features(images[2], 256, 0.02))
        frames = track_sequence(images, patch_size=24, fast_threshold=0.02,
                                matcher=Matcher(rng=fixed_draws))
        out[device] = ([t.cpu() for t in tensors], frames)
    for a, b in zip(out["cpu"][0], out["cuda"][0]):
        assert torch.equal(a, b)
    assert int(out["cpu"][0][-1].sum()) > 50
    for a, b in zip(out["cpu"][1], out["cuda"][1]):
        assert np.array_equal(a.ids, b.ids)
        assert np.array_equal(a.coords, b.coords)


@pytest.mark.cuda
def test_vitamin_e_vo_card_equals_cpu():
    """VitaminEVO over the sequence with the same draws on the CPU and
    twice on the card: every pose, every keypoint frame and the map
    bit-equal."""
    from tadataka_torch.vo.vitamin_e import VitaminEVO
    needs_card()
    seq = vitamin_e_frames()
    runs = []
    for device in ("cpu", "cuda", "cuda"):
        vo = VitaminEVO(seq[0].camera_model, fast_threshold=0.02,
                        lambda_=0.5, device=device, rng=fixed_draws)
        poses = [vo.estimate(f.image) for f in seq]
        runs.append((poses, vo))
    assert all(p is not None for p in runs[0][0])
    for poses, vo in runs[1:]:
        for a, b in zip(runs[0][0], poses):
            assert torch.equal(a.R, b.R) and torch.equal(a.t, b.t)
        for a, b in zip(runs[0][1].keypoints, vo.keypoints):
            assert np.array_equal(a.ids, b.ids)
            assert np.array_equal(a.coords, b.coords)
        assert sorted(vo.points) == sorted(runs[0][1].points)
        assert all(np.array_equal(vo.points[k], runs[0][1].points[k])
                   for k in vo.points)
