"""Parity of the port's feature front end (``features/{detector,brief,
matching,ransac,filters}.py``) with the JAX package's, on the CPU.

Frames: the JAX package's multi-plane scene at 120x160 on the trajectory
of ``tests/vo/test_feature_based.py``.  The RANSAC draws are the JAX
package's own: the port gets a callable that returns
``jax.random.uniform`` of the key the JAX code uses at that site.

Tolerances: detection, NMS, top-k, BRIEF, Hamming, matching and every
mask are bit-equal (the port sums in XLA's CPU order, and its sorts and
argmins take the first index among ties, as JAX's do); Harris is held
to 1e-6 of its range and its keypoints to 1e-4 px; the affine matrix
to 1e-4 after scaling to unit norm, F by its residuals (within a tenth
of the RANSAC threshold), since SVDs and solves round by library.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

from tadataka_tpu.core.pose import Pose as JPose
from tadataka_tpu.dataset.synthetic import multi_plane_scene as jscene
from tadataka_tpu.features import brief as jbrief
from tadataka_tpu.features import detector as jdetector
from tadataka_tpu.features import filters as jfilters
from tadataka_tpu.features import matching as jmatching
from tadataka_tpu.features import ransac as jransac

from tadataka_torch.features import brief, detector, filters, matching, ransac
from tadataka_torch.interop import features_from_numpy, matches_from_numpy


def jax_uniform(site, shape):
    """The JAX package's draws at ``site``: PRNGKey(3939), split among the
    V pairs of one ``match_many`` call."""
    key = jax.random.PRNGKey(3939)
    if isinstance(site, tuple) and site[0] == "match":
        key = jax.random.split(key, site[2])[site[1]]
    return np.asarray(jax.random.uniform(key, shape))


def T(a, dtype=None):
    return torch.tensor(np.array(a), dtype=dtype)


@pytest.fixture(scope="module")
def scene():
    poses = [JPose.from_rotvec(jnp.array([0.0, 0.002 * i, 0.0]),
                               jnp.array([0.25 * i, 0.01 * i, 0.02 * i]))
             for i in range(3)]
    ds = jscene(n_frames=3, image_shape=(120, 160),
                focal_length=(120.0, 120.0), poses=poses)
    return [np.array(ds[i].image, np.float32) for i in range(3)], \
        ds[0].camera_model


@pytest.fixture(scope="module")
def features(scene):
    """Each frame's FAST + BRIEF features with normalized keypoints, from
    both packages."""
    images, camera_model = scene
    out = []
    for image in images:
        f = jbrief.extract_features(jnp.asarray(image), 512, 0.02, 24)
        f = f._replace(keypoints=camera_model.normalize(f.keypoints))
        out.append((f, features_from_numpy(*f)))
    return out


@pytest.fixture(scope="module")
def matched(features):
    """Frame 0 against frame 1: (kp1, kp2, mask) of JAX's matches."""
    (f0, _), (f1, _) = features[0], features[1]
    m = jmatching.match_descriptors(f0.descriptors, f1.descriptors,
                                    f0.mask, f1.mask)
    kp1 = np.asarray(f0.keypoints)[np.asarray(m.indices[:, 0])]
    kp2 = np.asarray(f1.keypoints)[np.asarray(m.indices[:, 1])]
    return kp1, kp2, np.asarray(m.mask)


@pytest.mark.parametrize("threshold", [0.02, 20.0 / 255.0, 10.0 / 255.0])
def test_fast_score_bit_equal(scene, threshold):
    image = scene[0][0]
    ref = np.asarray(jdetector.fast_score(jnp.asarray(image), threshold))
    out = detector.fast_score(T(image), threshold).numpy()
    assert (ref > 0).sum() > 50
    assert_array_equal(out, ref)


def test_nms3_bit_equal(scene):
    image = scene[0][0]
    raw = np.asarray(jdetector.fast_score(jnp.asarray(image), 0.02))
    assert_array_equal(detector._nms3(T(raw)).numpy(),
                       np.asarray(jdetector._nms3(jnp.asarray(raw))))


def test_harris_score(scene):
    image = scene[0][0]
    ref = np.asarray(jdetector.harris_score(jnp.asarray(image)))
    out = detector.harris_score(T(image)).numpy()
    assert_allclose(out, ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    assert_array_equal(detector._gaussian_kernel(1.0),
                       np.asarray(jdetector._gaussian_kernel(1.0)))


@pytest.mark.parametrize("frame", [0, 1])
def test_detect_fast_bit_equal(scene, frame):
    image = scene[0][frame]
    ref = jdetector.detect_fast(jnp.asarray(image), 0.02, 512)
    out = detector.detect_fast(T(image), 0.02, 512)
    assert int(ref.mask.sum()) > 200
    assert_array_equal(out.keypoints.numpy(), np.asarray(ref.keypoints))
    assert_array_equal(out.mask.numpy(), np.asarray(ref.mask))
    assert out.descriptors.shape == (512, 0)


def test_detect_harris(scene):
    image = scene[0][0]
    ref = jdetector.detect_harris(jnp.asarray(image), 256)
    out = detector.detect_harris(T(image), 256)
    assert_array_equal(out.mask.numpy(), np.asarray(ref.mask))
    assert_allclose(out.keypoints.numpy(), np.asarray(ref.keypoints),
                    rtol=0, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_topk_keypoints_ties(seed):
    """A planted map of a few distinct values (most of them 0, the rest
    tied in groups): the order of ``lax.top_k`` (the lower flat index first
    among equal scores) exactly, also where k reaches into the zeros,
    and the subpixel refinement on a separate response."""
    rng = np.random.default_rng(seed)
    score = rng.choice([0.0, 0.0, 0.0, 0.25, 0.5, 1.0], (30, 40))
    score = score.astype(np.float32)
    sub = rng.random((30, 40)).astype(np.float32)
    for k in (16, 400, 1200):
        ref = jdetector._topk_keypoints(jnp.asarray(score), k,
                                        subpixel_score=jnp.asarray(sub))
        out = detector._topk_keypoints(T(score), k, subpixel_score=T(sub))
        assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
        assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
        ref = jdetector._topk_keypoints(jnp.asarray(score), k)
        out = detector._topk_keypoints(T(score), k)
        assert_array_equal(out[0].numpy(), np.asarray(ref[0]))


def test_brief_pattern_and_smoothing(scene):
    for a, b in zip(brief._uniform_pattern(), jbrief._uniform_pattern()):
        assert np.array_equal(a, b)
    for a, b in zip(brief._uniform_pattern(256, 24),
                    jbrief._uniform_pattern(256, 24)):
        assert np.array_equal(a, b)
    image = scene[0][0]
    assert_array_equal(brief._smooth(T(image)).numpy(),
                       np.asarray(jbrief._smooth(jnp.asarray(image))))


@pytest.mark.parametrize("patch_size", [24, 64])
def test_brief_descriptors_bit_equal(scene, patch_size):
    image = scene[0][1]
    feats = jdetector.detect_fast(jnp.asarray(image), 0.02, 256)
    ref = jbrief.brief_descriptors(jnp.asarray(image), feats.keypoints,
                                   feats.mask, patch_size)
    out = brief.brief_descriptors(T(image), T(feats.keypoints),
                                  T(feats.mask), patch_size)
    assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    assert_array_equal(out[1].numpy(), np.asarray(ref[1]))


@pytest.mark.parametrize("frame", [0, 2])
def test_extract_features_bit_equal(scene, frame):
    image = scene[0][frame]
    ref = jbrief.extract_features(jnp.asarray(image), 512, 0.02, 24)
    out = brief.extract_features(T(image), 512, 0.02, 24)
    assert int(ref.mask.sum()) > 200
    for a, b in zip(out, ref):
        assert_array_equal(a.numpy(), np.asarray(b))


def test_hamming_distances_exact(features):
    (f0, p0), (f1, p1) = features[0], features[1]
    ref = np.asarray(jmatching.hamming_distances(f0.descriptors,
                                                 f1.descriptors))
    out = matching.hamming_distances(p0.descriptors, p1.descriptors).numpy()
    assert_array_equal(out, ref)


def planted_codes(seed, K1=60, K2=50, D=32):
    """+-1 codes where set 2 repeats rows (so distances tie within a row
    and within a column) and both masks drop some rows."""
    rng = np.random.default_rng(seed)
    d1 = rng.choice([-1.0, 1.0], (K1, D)).astype(np.float32)
    base = rng.choice([-1.0, 1.0], (K2 // 2, D)).astype(np.float32)
    d2 = np.concatenate([base, base[::-1]])
    d2[:10] = d1[5:15]                 # exact matches, some repeated
    d2[30:35] = d1[5:10]
    m1 = rng.random(K1) > 0.1
    m2 = rng.random(K2) > 0.1
    return d1, d2, m1, m2


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cross_check", [True, False])
@pytest.mark.parametrize("max_ratio", [0.8, 1.0])
def test_match_descriptors_ties(seed, cross_check, max_ratio):
    d1, d2, m1, m2 = planted_codes(seed)
    ref = jmatching.match_descriptors(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(m1), jnp.asarray(m2),
        cross_check=cross_check, max_ratio=max_ratio)
    out = matching.match_descriptors(T(d1), T(d2), T(m1), T(m2),
                                     cross_check=cross_check,
                                     max_ratio=max_ratio)
    assert_array_equal(out.indices.numpy(), np.asarray(ref.indices))
    assert_array_equal(out.mask.numpy(), np.asarray(ref.mask))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("radius", [0.05, 0.2])
def test_match_descriptors_guided_ties(seed, radius):
    d1, d2, m1, m2 = planted_codes(seed)
    rng = np.random.default_rng(seed + 10)
    kp2 = rng.uniform(-0.5, 0.5, (len(d2), 2)).astype(np.float32)
    pred = rng.uniform(-0.5, 0.5, (len(d1), 2)).astype(np.float32)
    pred[5:15] = kp2[:10] + 0.01
    ref = jmatching.match_descriptors_guided(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(m1), jnp.asarray(m2),
        jnp.asarray(pred), jnp.asarray(kp2), jnp.float32(radius))
    out = matching.match_descriptors_guided(
        T(d1), T(d2), T(m1), T(m2), T(pred), T(kp2), radius)
    assert int(np.asarray(ref.mask).sum()) > 3
    assert_array_equal(out.indices.numpy(), np.asarray(ref.indices))
    assert_array_equal(out.mask.numpy(), np.asarray(ref.mask))


def test_match_descriptors_frames(features):
    (f0, p0), (f1, p1) = features[0], features[1]
    ref = jmatching.match_descriptors(f0.descriptors, f1.descriptors,
                                      f0.mask, f1.mask)
    out = matching.match_descriptors(p0.descriptors, p1.descriptors,
                                     p0.mask, p1.mask)
    assert int(np.asarray(ref.mask).sum()) > 100
    assert_array_equal(out.indices.numpy(), np.asarray(ref.indices))
    assert_array_equal(out.mask.numpy(), np.asarray(ref.mask))


def test_sample_valid_indices(matched):
    mask = matched[2].copy()
    mask[::3] = False
    key = jax.random.PRNGKey(7)
    ref = jransac._sample_valid_indices(key, jnp.asarray(mask), 128, 8)
    r = np.asarray(jax.random.uniform(key, (128, 8)))
    out = ransac._sample_valid_indices(T(r), T(mask))
    assert_array_equal(out.numpy(), np.asarray(ref))


def unit(M):
    M = np.asarray(M, np.float64)
    return M / np.linalg.norm(M)


@pytest.mark.parametrize("threshold", [0.002, 0.005])
def test_ransac_fundamental(matched, threshold):
    kp1, kp2, mask = matched
    F_ref, in_ref = jransac.ransac_fundamental(
        jnp.asarray(kp1), jnp.asarray(kp2), jnp.asarray(mask),
        jax.random.PRNGKey(3939), residual_threshold=threshold)
    F, inliers = ransac.ransac_fundamental(
        T(kp1), T(kp2), T(mask), jax_uniform, residual_threshold=threshold)
    assert int(np.asarray(in_ref).sum()) > 100
    assert_array_equal(inliers.numpy(), np.asarray(in_ref))
    # F from 8 samples of a near-planar scene is ill-conditioned (the
    # chosen trial's F differs by up to 2% between LAPACK builds), so
    # F is held by what follows from it: the residuals of every match
    d_ref = np.sqrt(np.asarray(jransac.sampson_distance(
        F_ref, jnp.asarray(kp1), jnp.asarray(kp2))))
    d = torch.sqrt(ransac.sampson_distance(F, T(kp1), T(kp2))).numpy()
    assert_allclose(d, d_ref, rtol=0, atol=0.1 * threshold)


def test_ransac_affine(matched):
    kp1, kp2, mask = matched
    M_ref, in_ref = jransac.ransac_affine(
        jnp.asarray(kp1), jnp.asarray(kp2), jnp.asarray(mask),
        jax.random.PRNGKey(3939), residual_threshold=0.01)
    M, inliers = ransac.ransac_affine(T(kp1), T(kp2), T(mask), jax_uniform,
                                      residual_threshold=0.01)
    assert int(np.asarray(in_ref).sum()) > 100
    assert_array_equal(inliers.numpy(), np.asarray(in_ref))
    assert_allclose(unit(M.numpy()), unit(M_ref), rtol=0, atol=1e-4)


def test_symmetric_transfer_filter(matched):
    kp1, kp2, mask = matched
    ref = jfilters.symmetric_transfer_filter(
        jnp.asarray(kp1), jnp.asarray(kp2), jnp.asarray(mask))
    out = filters.symmetric_transfer_filter(T(kp1), T(kp2), T(mask))
    assert int(np.asarray(ref).sum()) > 100
    assert_array_equal(out.numpy(), np.asarray(ref))


def test_matcher_and_match_many(features):
    (f0, p0), (f1, p1), (f2, p2) = features
    jm = jmatching.Matcher()
    pm = matching.Matcher(rng=jax_uniform)
    ref = matches_from_numpy(*jm(f0, f1))
    out = pm(p0, p1)
    assert torch.equal(out.indices, ref.indices)
    assert torch.equal(out.mask, ref.mask)
    assert int(out.n_valid) == int(ref.n_valid) > 100
    ref_idx, ref_masks = jm.match_many([f0, f1], f2)
    idx, masks = pm.match_many([p0, p1], p2)
    assert (np.asarray(ref_masks).sum(1) > 100).all()
    assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    assert_array_equal(masks.numpy(), np.asarray(ref_masks))
    # pairs under min_inliers matches stay unfiltered
    ref_idx, ref_masks = jm.match_many([f0], f2, min_inliers=10_000)
    idx, masks = pm.match_many([p0], p2, min_inliers=10_000)
    assert_array_equal(masks.numpy(), np.asarray(ref_masks))


def test_matcher_default_generator(features):
    """With no draws given, the Matcher seeds its own generator on the
    features' device and its RANSAC keeps most matches on this scene."""
    (_, p0), (_, p1) = features[0], features[1]
    m = matching.Matcher()(p0, p1)
    before = matching.match_descriptors(p0.descriptors, p1.descriptors,
                                        p0.mask, p1.mask).mask
    assert int(m.mask.sum()) > 0.8 * int(before.sum())
