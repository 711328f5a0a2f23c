"""The port's VITAMIN-E VO (``robust/irls.py``, ``features/{flow,
curvature,extrema_tracker}.py``, ``vo/vitamin_e.py``) against the JAX
package's, on the CPU, on ``tests/vo/test_vitamin_e.py``'s multi-plane
sequence at 120x160 (focal 120), with the JAX package's RANSAC draws.

Stage by stage, each stage is fed the JAX package's output of the stage
before (through ``interop``):
- IRLS: ``jnp.median``'s midpoint equal; MAD scale and Huber weights
  within an ulp; the 30-step fit's values within 1e-3 px (the float32
  normal equations of pixel coordinates are ill conditioned).
- Curvature: each product is rounded on its own in the port, while
  XLA's CPU compiler may fuse a * b + c into one FMA, so the curvature
  agrees within 1e-6 of its largest magnitude and the percentile
  threshold within one ulp; fed JAX's curvature map, the extrema are
  equal but for pixels within one ulp of the threshold, which are
  counted and set aside.
- The hill climb, fed JAX's curvature and predictions: the landing
  pixels equal, the subpixel offsets within 1e-6.
- The tracker and the id bookkeeping, fed JAX's flow and keypoint
  frame: ids equal, coordinates within 1e-5 px.
The whole ``track_sequence`` gives the same ids and coordinates within
1e-4 px; the whole ``VitaminEVO`` bootstraps within 1e-3 with the same
map.  Past the bootstrap PnP's RANSAC over EPnP trials flips on last
bits as in the feature VO (``tests/test_torch_feature_vo.py``), so the
run is held to JAX's quality, and frame 3 is run from the JAX VO's own
state (``interop.vitamin_e_state_from_numpy``).
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tadataka_tpu.core.pose import Pose as JPose
from tadataka_tpu.dataset.synthetic import multi_plane_scene
from tadataka_tpu.features import curvature as jcurvature
from tadataka_tpu.features import extrema_tracker as jextrema
from tadataka_tpu.features import flow as jflow
from tadataka_tpu.features.brief import extract_features as jextract
from tadataka_tpu.features.matching import Matcher as JMatcher
from tadataka_tpu.robust import irls as jirls
from tadataka_tpu.vo import vitamin_e as jvit

from tadataka_torch import interop
from tadataka_torch.features import curvature, extrema_tracker, flow
from tadataka_torch.features.matching import Matcher
from tadataka_torch.robust import irls
from tadataka_torch.vo import vitamin_e as vit

N_FRAMES = 4


def jax_uniform(site, shape):
    """The JAX package's RANSAC draws: PRNGKey(3939) at every site."""
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(3939), shape))


def T(a, dtype=torch.float32):
    return torch.tensor(np.array(a), dtype=dtype)


@pytest.fixture(scope="module")
def frames():
    poses = [JPose.from_rotvec(jnp.array([0.0, 0.003 * i, 0.0]),
                               jnp.array([0.15 * i, 0.01 * i, 0.0]))
             for i in range(N_FRAMES)]
    ds = multi_plane_scene(n_frames=N_FRAMES, image_shape=(120, 160),
                           focal_length=(120.0, 120.0), poses=poses)
    return [ds[i] for i in range(N_FRAMES)]


@pytest.fixture(scope="module")
def images(frames):
    return [np.array(f.image, np.float32) for f in frames]


@pytest.fixture(scope="module")
def jax_features(images):
    return [jextract(jnp.asarray(im), max_keypoints=512, threshold=0.02,
                     patch_size=24) for im in images]


def port_camera(frame):
    p = frame.camera_model.camera_parameters
    return interop.camera_model_from_numpy(p.focal_length, p.offset)


def ulps(a, b):
    return np.abs(np.asarray(a, np.float32).view(np.int32).astype(np.int64)
                  - np.asarray(b, np.float32).view(np.int32)
                  .astype(np.int64))


def test_irls(images):
    """median equal (odd and even counts); MAD scale and Huber weights
    within 1 ulp; the fitted values within 1e-3 px, on an affine
    regression of coordinates up to 160 px with 10% outliers."""
    g = np.random.default_rng(0)
    for n in (7, 8, 301):
        x = g.normal(0, 1, n).astype(np.float32)
        assert irls.median(T(x)).numpy() == np.asarray(
            jirls._median(jnp.asarray(x)))
        assert ulps(irls.mad_scale(T(x)).numpy(),
                    jirls.mad_scale(jnp.asarray(x))) <= 1
        assert ulps(irls.huber_weights(T(x)).numpy(),
                    jirls.huber_weights(jnp.asarray(x))).max() <= 1
    X = np.c_[g.uniform(0, 160, (300, 2)), np.ones(300)].astype(np.float32)
    y = (X @ [1.01, 0.02, 3.0] + g.normal(0, 0.3, 300)).astype(np.float32)
    y[:30] += 20.0
    ref = np.asarray(jirls.irls_fit(jnp.asarray(X), jnp.asarray(y)))
    out = irls.irls_fit(T(X), T(y)).numpy()
    # the normal equations of pixel coordinates up to 160 are ill
    # conditioned in float32 (JAX's LU solve against the adjugate
    # inverse): the fitted values agree within 1e-3 px
    np.testing.assert_allclose(X @ out, X @ ref, rtol=0, atol=1e-3)
    both = irls.irls_fit(T(X), T(np.stack([y, 2 * y])))
    assert torch.equal(both[0], irls.irls_fit(T(X), T(y)))


def test_affine_flow(images, jax_features):
    """estimate_affine_transform on JAX's matches of frames 0 and 1, also
    masked: the fitted map within 1e-3 px of JAX's over the image (its
    IRLS normal equations are ill conditioned in float32); the map and
    its inverse of JAX's matrix within 1e-4 px."""
    f0, f1 = jax_features[:2]
    matches = JMatcher()(f0, f1)
    idx = np.asarray(matches.indices)[np.asarray(matches.mask)]
    kp0 = np.asarray(f0.keypoints)[idx[:, 0]]
    kp1 = np.asarray(f1.keypoints)[idx[:, 1]]
    ref = jflow.estimate_affine_transform(jnp.asarray(kp0), jnp.asarray(kp1))
    out = flow.estimate_affine_transform(T(kp0), T(kp1))
    pts = np.random.default_rng(1).uniform(0, 160, (50, 2)).astype(
        np.float32)
    np.testing.assert_allclose(out(T(pts)).numpy(),
                               np.asarray(ref(jnp.asarray(pts))), atol=1e-3)
    M = interop.affine_from_numpy(np.asarray(ref.matrix))
    np.testing.assert_allclose(M(T(pts)).numpy(),
                               np.asarray(ref(jnp.asarray(pts))), atol=1e-4)
    np.testing.assert_allclose(M.inverse(T(pts)).numpy(),
                               np.asarray(ref.inverse(jnp.asarray(pts))),
                               atol=1e-4)
    masked = flow.estimate_affine_transform(
        T(kp0), T(kp1), T(np.arange(len(kp0)) % 5 != 0, torch.bool))
    ref = jflow.estimate_affine_transform(
        jnp.asarray(kp0), jnp.asarray(kp1),
        jnp.asarray(np.arange(len(kp0)) % 5 != 0))
    np.testing.assert_allclose(masked(T(pts)).numpy(),
                               np.asarray(ref(jnp.asarray(pts))), atol=1e-3)


@pytest.mark.parametrize("frame", [0, 2])
def test_curvature_and_extrema(images, frame):
    image = images[frame]
    ref = np.asarray(jcurvature.compute_image_curvature(jnp.asarray(image)))
    out = curvature.compute_image_curvature(T(image)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())
    g = np.random.default_rng(frame)
    for x in (ref, g.normal(0, 1, 1001).astype(np.float32)):
        for p in (98.0, 95.0, 50.0):
            assert ulps(curvature.percentile_of(T(x), p).numpy(),
                        jnp.percentile(jnp.asarray(x), p)) <= 1
    # extrema of JAX's curvature map, against JAX's own
    kps, mask = curvature.curvature_extrema(T(ref), 98.0, 2048)
    jkps, jmask = jcurvature.extract_curvature_extrema(
        jnp.asarray(image), 98.0, 2048)
    jkps, jmask = np.asarray(jkps), np.asarray(jmask)
    threshold = np.asarray(jnp.percentile(jnp.asarray(ref), 98.0))
    xy = kps.numpy().astype(int)
    near = ulps(ref[xy[:, 1], xy[:, 0]], threshold) <= 1
    jxy = jkps.astype(int)
    jnear = ulps(ref[jxy[:, 1], jxy[:, 0]], threshold) <= 1
    kept = kps.numpy()[mask.numpy() & ~near]
    jkept = jkps[jmask & ~jnear]
    assert len(kept) > 300
    np.testing.assert_array_equal(kept, jkept)
    assert (mask.numpy() & near).sum() + (jmask & jnear).sum() <= 2


def test_extrema_tracker(images):
    """Fed JAX's curvature of frame 1 and the same predictions (some off
    the image): landing pixels equal, subpixel offsets within 1e-6."""
    curv = jcurvature.compute_image_curvature(jnp.asarray(images[1]))
    kps = np.asarray(jvit.init_keypoint_frame(images[0]).coords)
    g = np.random.default_rng(3)
    pred = (kps + g.normal(0, 1.5, kps.shape)).astype(np.float32)
    pred[:5] = [[-3, 4], [170, 50], [10, -1], [159.4, 119.4], [0.2, 0.4]]
    for subpixel in (True, False):
        ref = np.asarray(jextrema.ExtremaTracker(
            curv, 0.5, subpixel=subpixel).optimize(jnp.asarray(pred)))
        out = extrema_tracker.ExtremaTracker(
            T(np.asarray(curv)), 0.5, subpixel=subpixel).optimize(
                T(pred)).numpy()
        np.testing.assert_array_equal(np.round(out), np.round(ref))
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6 * 160)
    moved = np.round(out) != np.round(pred)
    assert moved.any(axis=1).mean() > 0.3


def hill(center, H=32, W=32):
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    return np.exp(-((xs - center[0]) ** 2 + (ys - center[1]) ** 2)
                  / 8.0).astype(np.float32)


@pytest.mark.parametrize("curv,lambda_,start", [
    (hill((12, 20)), 0.0, [[10.0, 18.0], [14.0, 22.0]]),
    (hill((25, 25)), 1e6, [[5.0, 5.0]]),
    (np.zeros((16, 16), np.float32), 0.1, [[-5.0, 3.0], [100.0, 3.0]])])
def test_extrema_tracker_small_cases(curv, lambda_, start):
    """``tests/features/test_features.py``'s 32x32 and 16x16 cases: the
    climb to a hill, the regularizer's hold, out-of-image pass-through;
    equal to JAX's within 1e-6."""
    start = np.asarray(start, np.float32)
    ref = np.asarray(jextrema.ExtremaTracker(jnp.asarray(curv), lambda_)
                     .optimize(jnp.asarray(start)))
    out = extrema_tracker.ExtremaTracker(T(curv), lambda_).optimize(
        T(start)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def test_affine_flow_small_case():
    """``tests/features/test_features.py``'s IRLS flow: 60 points up to 40
    px with 5 gross outliers; the map within 1e-4 px of JAX's over the
    points and their round trip within 1e-4 px."""
    g = np.random.default_rng(0)
    src = g.uniform(0, 40, (60, 2)).astype(np.float32)
    M = np.array([[1.02, -0.03, 3.0], [0.05, 0.97, -2.0], [0, 0, 1]],
                 np.float32)
    dst = (np.hstack([src, np.ones((60, 1))]) @ M.T)[:, :2]
    dst = (dst + g.normal(0, 0.05, dst.shape)).astype(np.float32)
    dst[:5] += 30.0
    ref = jflow.estimate_affine_transform(jnp.asarray(src), jnp.asarray(dst))
    out = flow.estimate_affine_transform(T(src), T(dst))
    np.testing.assert_allclose(out(T(src)).numpy(),
                               np.asarray(ref(jnp.asarray(src))), atol=1e-4)
    np.testing.assert_allclose(out.inverse(out(T(src))).numpy(), src,
                               atol=1e-4)


def test_tracker_from_jax_inputs(images, jax_features):
    """Fed JAX's keypoint frame of frame 0 and its flow to frame 1: the
    same ids, coordinates within 1e-5 px; the new area's keypoints
    within 1e-5 px; id matching exact."""
    kf0 = jvit.init_keypoint_frame(images[0])
    jflow01 = jvit.estimate_flow(jax_features[0], jax_features[1])
    ref = jvit.Tracker(jflow01, images[1], 0.5)(kf0)
    flow01 = interop.affine_from_numpy(np.asarray(jflow01.matrix))
    out = vit.Tracker(flow01, T(images[1]), 0.5)(
        interop.keypoint_frame_from_numpy(kf0.ids, kf0.coords))
    np.testing.assert_array_equal(out.ids, ref.ids)
    np.testing.assert_allclose(out.coords, ref.coords, rtol=0, atol=1e-5)
    new = vit.keypoints_from_new_area(T(images[1]), flow01)
    jnew = jvit.keypoints_from_new_area(images[1], jflow01)
    np.testing.assert_allclose(new, jnew, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(vit.match_keypoints(out, ref),
                                  jvit.match_keypoints(ref, ref))
    np.testing.assert_array_equal(
        vit.match_multiple_keypoints([out, ref, out]),
        jvit.match_multiple_keypoints([ref, ref, ref]))


@pytest.fixture(scope="module")
def tracks(images):
    ref = jvit.track_sequence(images, lambda_=0.5, patch_size=24,
                              fast_threshold=0.02)
    out = vit.track_sequence([T(im) for im in images],
                             lambda_=0.5, patch_size=24, fast_threshold=0.02,
                             matcher=Matcher(rng=jax_uniform))
    return ref, out


def test_track_sequence(tracks):
    """The whole chain: the same ids every frame, coordinates within
    1e-4 px, more than 50 tracks through all frames."""
    ref, out = tracks
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_allclose(a.coords, b.coords, rtol=0, atol=1e-4)
    assert vit.match_multiple_keypoints(out).shape[0] > 50


def test_triangulate_tracks(frames, tracks):
    """JAX's tracks and the true poses: points within 1e-4 of their
    depth, depths within 1e-4 relative."""
    ref_tracks, _ = tracks
    jposes = [f.pose.inv() for f in frames]
    jpoints, jdepths = jvit.triangulate_tracks(
        [f.camera_model for f in frames], jposes, ref_tracks)
    points, depths = vit.triangulate_tracks(
        [port_camera(f) for f in frames],
        interop.poses_from_numpy(jposes), ref_tracks)
    jdepths = np.asarray(jdepths)
    np.testing.assert_allclose(depths.numpy(), jdepths, rtol=1e-4)
    np.testing.assert_allclose(points.numpy(), np.asarray(jpoints),
                               rtol=0, atol=1e-4 * np.abs(jdepths).max())


@pytest.fixture(scope="module")
def vo_runs(frames, images):
    """Both VOs over the frames; then, from the JAX VO's state after
    frame 2, frame 3 on a port VO that carries it."""
    jvo = jvit.VitaminEVO(frames[0].camera_model, fast_threshold=0.02,
                          lambda_=0.5)
    pvo = vit.VitaminEVO(port_camera(frames[0]), fast_threshold=0.02,
                         lambda_=0.5, device="cpu", rng=jax_uniform)
    out = []
    for k, im in enumerate(images):
        if k == 3:
            carried = [interop.vitamin_e_state_from_numpy(
                vit.VitaminEVO(port_camera(frames[0]), fast_threshold=0.02,
                               lambda_=0.5, device="cpu", rng=jax_uniform),
                list(jvo.poses_cw), list(jvo.keypoints),
                tuple(jvo._features), dict(jvo.points),
                dict(jvo._first_obs), dict(jvo._tri_gap)) for _ in range(2)]
        out.append((jvo.estimate(im), pvo.estimate(im),
                    sorted(jvo.points), sorted(pvo.points)))
        if k == 3:
            carried[0].estimate(im)
            state = (*carried, jvo.poses_cw[3], jvo.keypoints[3],
                     dict(jvo.points))
    return out, state


def aligned_share(est, gt):
    """Aligned ATE over the true extent."""
    from tadataka_torch.metrics import absolute_trajectory_error
    est, gt = np.asarray(est, np.float64), np.asarray(gt, np.float64)
    return float(absolute_trajectory_error(est, gt)) / float(
        np.linalg.norm(gt[-1] - gt[0]))


def test_vitamin_e_vo(frames, vo_runs):
    """From the start: a pose every frame; the bootstrap (frames 0-1)
    within 1e-3 (R, t; |t| ~ 1 after the scale-free bootstrap) with the
    same map ids, over 200 points.  Past it PnP's RANSAC over EPnP trials
    flips on last bits (the problem is ill conditioned: from the same
    state on frame 3 the chosen trial's consensus differs by a few points
    between LAPACK builds, and the refined poses by up to 20%), so the
    whole run is held to the JAX package's quality: the aligned ATE over
    the true extent under 1.25 x JAX's + 0.02."""
    out, _ = vo_runs
    assert all(pj is not None and pp is not None for pj, pp, _, _ in out)
    for pj, pp, jids, pids in out[:2]:
        np.testing.assert_allclose(pp.R.numpy(), np.asarray(pj.R), atol=1e-3)
        np.testing.assert_allclose(pp.t.numpy(), np.asarray(pj.t), atol=1e-3)
        assert jids == pids
    assert len(out[1][2]) > 200
    gt = [np.asarray(f.pose.t) for f in frames]
    jshare = aligned_share([np.asarray(pj.t) for pj, _, _, _ in out], gt)
    pshare = aligned_share([pp.t.numpy() for _, pp, _, _ in out], gt)
    assert pshare < 1.25 * jshare + 0.02, (pshare, jshare)


def test_vitamin_e_from_jax_state(vo_runs):
    """Frame 3 from the JAX VO's state after frame 2: the same tracks
    (ids equal, coordinates within 1e-4 px), and a PnP pose that fits the
    map as well as JAX's (its inliers at the 0.005 gate within 10% of
    JAX's pose's); the triangulation from JAX's frame-3 pose gives the
    same map ids, and points within 2e-5 d max(d, 5) of their depth d:
    1e-4 of it in the scene (5-10 m), more for tracks of almost no
    parallax, which reach depths of thousands (a depth's rounding error
    grows as d^2 / baseline)."""
    _, (pvo, mapper, jpose, jkp, jpoints) = vo_runs
    np.testing.assert_array_equal(pvo.keypoints[3].ids, jkp.ids)
    np.testing.assert_allclose(pvo.keypoints[3].coords, jkp.coords,
                               atol=1e-4)

    def inliers(R, t, kp):
        sel = [i for i, tid in enumerate(kp.ids) if tid in pvo.points]
        pts = np.stack([pvo.points[kp.ids[i]] for i in sel])
        norm = pvo._normalize(kp.coords[sel]).numpy()
        P = pts @ np.asarray(R).T + np.asarray(t)
        return int((np.linalg.norm(P[:, :2] / P[:, 2:] - norm, axis=1)
                    < 0.005).sum())

    pose = pvo.poses_cw[3]
    ours, theirs = (inliers(pose.R.numpy(), pose.t.numpy(), jkp),
                    inliers(jpose.R, jpose.t, jkp))
    assert ours >= 0.9 * theirs > 50, (ours, theirs)
    # the map from JAX's pose and tracks: estimate's last steps
    kp = interop.keypoint_frame_from_numpy(jkp.ids, jkp.coords)
    mapper.poses_cw.append(interop.pose_from_numpy(jpose.R, jpose.t))
    mapper.keypoints.append(kp)
    mapper._record_first_obs(3, kp)
    mapper._triangulate_new(3, kp)
    assert sorted(mapper.points) == sorted(jpoints)
    for k, x in jpoints.items():
        depth = abs(x[2])
        assert np.abs(mapper.points[k] - x).max() <= (
            2e-5 * max(depth, 5.0) * depth), k


def test_defaults_to_the_card(frames):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vit.VitaminEVO(port_camera(frames[0]))


def test_vitamin_e_runs_without_jax():
    """VITAMIN-E's and ORB's modules import and run 3 frames on the CPU
    with jax and the JAX package unimportable."""
    script = textwrap.dedent("""
        import sys
        for name in ("jax", "tadataka_tpu"):
            sys.modules[name] = None
        import torch
        import tadataka_torch.core
        import tadataka_torch.features
        from tadataka_torch.core.pose import Pose
        from tadataka_torch.dataset import multi_plane_scene
        from tadataka_torch.features.orb import extract_orb_features
        from tadataka_torch.vo.vitamin_e import VitaminEVO
        poses = [Pose.from_rotvec(torch.tensor([0.0, 0.003 * i, 0.0]),
                                  torch.tensor([0.15 * i, 0.01 * i, 0.0]))
                 for i in range(3)]
        ds = multi_plane_scene(3, (120, 160), (120.0, 120.0), poses)
        vo = VitaminEVO(ds[0].camera_model, fast_threshold=0.02,
                        patch_size=24, device="cpu")
        assert all(vo.estimate(ds[i].image) is not None for i in range(3))
        assert int(extract_orb_features(ds[0].image, 128, 0.02).mask.sum())
        assert "jax" not in [m.split(".")[0] for m in sys.modules
                             if sys.modules[m] is not None]
        print("ok", len(vo.points))
    """)
    root = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", script], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("ok")
