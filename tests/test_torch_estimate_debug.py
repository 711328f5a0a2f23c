"""Parity of the semi-dense leftovers with the JAX package, on the CPU:
the one-pixel entry ``estimate_debug`` in each failure case of
tests/vo/test_semi_dense.py, ``update_depth(row_offset=)`` on a block
of rows, and ``frame.normalize`` / ``unnormalize`` and
``fusion.fusion_maps``.

The scene is that file's: a 60x80 keyframe and a refframe 0.5 m to its
right before a tilted plane at 10 m, rendered by the JAX package.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tadataka_tpu.camera import CameraParameters as JCameraParameters
from tadataka_tpu.core.pose import Pose as JPose
from tadataka_tpu.dataset import PlaneSceneDataset
from tadataka_tpu.flags import Flag as JFlag
from tadataka_tpu.vo.semi_dense import SemiDenseParams as JParams
from tadataka_tpu.vo.semi_dense import make_frame as jmake_frame
from tadataka_tpu.vo.semi_dense.estimator import (
    estimate_debug as jestimate_debug, update_depth as jupdate_depth)
from tadataka_tpu.vo.semi_dense.frame import (
    normalize as jnormalize, stack_frames as jstack,
    unnormalize as junnormalize)
from tadataka_tpu.vo.semi_dense.fusion import fusion_maps as jfusion_maps

from tadataka_torch import interop
from tadataka_torch.flags import Flag
from tadataka_torch.vo.semi_dense import (
    estimate_debug, fusion_maps, update_depth)
from tadataka_torch.vo.semi_dense.frame import normalize, unnormalize

H, W = 60, 80
FOCAL = (60.0, 60.0)
PARAMS_ARGS = dict(min_depth=2.0, max_depth=50.0, geo_coeff=0.01,
                   photo_coeff=0.01, ref_step_size=0.002, min_gradient=0.01)
# pixels across the image: the inside, and the borders, where the key
# patch or the epipolar segment leaves the image
PIXELS = [(40, 30), (25, 20), (60, 45), (10, 12), (70, 50), (33, 41),
          (1, 30), (78, 30), (40, 1), (40, 58), (3, 3), (76, 56)]


@pytest.fixture(scope="module")
def scene():
    poses = [JPose.identity(),
             JPose.from_rotvec(jnp.zeros(3), jnp.array([0.5, 0.0, 0.0]))]
    ds = PlaneSceneDataset(n_frames=2, image_shape=(H, W),
                           focal_length=FOCAL, poses=poses,
                           plane_origin=(0.0, 0.0, 10.0),
                           plane_normal=(0.05, -0.02, -1.0))
    key, ref = ds[0], ds[1]
    jcam = JCameraParameters.create(FOCAL, (W / 2, H / 2))
    keyframe = jmake_frame(jcam, key.image, key.pose.T)
    refframe = jmake_frame(jcam, ref.image, ref.pose.T)
    return keyframe, refframe, np.asarray(key.depth_map)


def debug_both(keyframe, refframe, u, depth, variance):
    """(JAX (depth, variance, flag), the port's) for one pixel."""
    jparams = JParams.create(**PARAMS_ARGS)
    j = [np.asarray(x) for x in jestimate_debug(
        jnp.float32(u), jnp.float32(depth), jnp.float32(variance),
        keyframe, refframe, jparams, n_ref_samples=64)]
    p = [x.numpy() for x in estimate_debug(
        u, depth, variance, interop.frame_from_numpy(*keyframe),
        interop.frame_from_numpy(*refframe),
        interop.params_from_numpy(jparams), n_ref_samples=64)]
    return j, p


@pytest.mark.parametrize("case", ["success", "negative_prior",
                                  "out_of_search_range",
                                  "insufficient_gradient"])
def test_estimate_debug_flags(scene, case):
    """Every pixel of PIXELS under each case of test_semi_dense.py: the
    port's flag is JAX's, and on SUCCESS depth and variance agree to rtol
    1e-5.  The case's own flag shows on the inner pixels (for "success",
    SUCCESS on at least half of them), and the prior's flag wins over
    every estimation flag."""
    keyframe, refframe, gt = scene
    if case == "insufficient_gradient":
        keyframe = keyframe._replace(image=jnp.full((H, W), 0.5,
                                                    jnp.float32))
    expected = {"negative_prior": JFlag.NEGATIVE_PRIOR_DEPTH,
                "out_of_search_range": JFlag.HYPOTHESIS_OUT_OF_SEARCH_RANGE,
                "insufficient_gradient": JFlag.INSUFFICIENT_GRADIENT,
                "success": JFlag.SUCCESS}[case]
    rng = np.random.default_rng(7)
    hits = 0
    for x, y in PIXELS:
        depth = float(gt[y, x] + rng.uniform(-2.0, 2.0))
        variance = 0.05
        if case == "negative_prior":
            depth = -5.0
        elif case == "out_of_search_range":
            depth, variance = 10000.0, 1e-5
        j, p = debug_both(keyframe, refframe, (float(x), float(y)), depth,
                          variance)
        assert int(p[2]) == int(j[2]), ((x, y), int(p[2]), int(j[2]))
        if int(j[2]) == int(Flag.SUCCESS):
            np.testing.assert_allclose(p[0], j[0], rtol=1e-5)
            np.testing.assert_allclose(p[1], j[1], rtol=1e-5)
        inner = 10 <= x < W - 10 and 10 <= y < H - 10
        hits += inner and int(j[2]) == int(expected)
    n_inner = sum(10 <= x < W - 10 and 10 <= y < H - 10 for x, y in PIXELS)
    if case == "success":
        assert hits >= n_inner / 2, hits
    elif case in ("negative_prior", "out_of_search_range"):
        assert hits == n_inner
    else:
        assert hits > 0


def test_estimate_debug_border_flags(scene):
    """A prior near the truth on the border pixels of PIXELS: the flags
    are JAX's, and they include geometric failures (key patch or
    epipolar segment out of the image)."""
    keyframe, refframe, gt = scene
    flags = []
    for x, y in PIXELS[6:]:
        j, p = debug_both(keyframe, refframe, (float(x), float(y)),
                          float(gt[y, x]), 0.05)
        assert int(p[2]) == int(j[2]), ((x, y), int(p[2]), int(j[2]))
        flags.append(int(p[2]))
    geometric = {int(Flag.KEY_OUT_OF_RANGE), int(Flag.REF_CLOSE_OUT_OF_RANGE),
                 int(Flag.REF_FAR_OUT_OF_RANGE)}
    assert geometric & set(flags), flags


@pytest.fixture(scope="module")
def block_inputs(scene):
    """A prior within 10% of the truth, variances and ages 0-1, seeded."""
    _, _, gt = scene
    gen = np.random.default_rng(8)
    prior = (gt * gen.uniform(0.9, 1.1, gt.shape)).astype(np.float32)
    variance = gen.uniform(0.002, 0.05, gt.shape).astype(np.float32)
    age = gen.integers(0, 2, gt.shape).astype(np.int32)
    age[:, ::7] = 1
    return prior, variance, age


@pytest.mark.parametrize("rows", [(0, 20), (20, 45), (45, 60)])
def test_update_depth_row_offset(scene, block_inputs, rows):
    """``update_depth`` on a block of rows with ``row_offset`` its first
    row: bit-equal to those rows of the port's whole-map update, and
    within test_torch_estimator.py's bounds of JAX's block update (flags
    on >= 99.5% of pixels, median relative depth difference on pixels
    SUCCESS on both <= 5e-5)."""
    keyframe, refframe, _ = scene
    prior, variance, age = block_inputs
    a, b = rows
    jparams = JParams.create(**PARAMS_ARGS)
    refs = jstack([refframe])
    key_t = interop.frame_from_numpy(*keyframe)
    refs_t = interop.frame_from_numpy(*refs)
    params_t = interop.params_from_numpy(jparams)

    def port(block, offset):
        return interop.to_numpy(update_depth(
            key_t, refs_t, interop.tensor(age[block], dtype=torch.int32),
            interop.tensor(prior[block]), interop.tensor(variance[block]),
            params_t, row_offset=offset))

    whole = port(slice(None), 0)
    block = port(slice(a, b), a)
    tensor_offset = port(slice(a, b), torch.tensor(a))
    for w, p, q in zip(whole, block, tensor_offset):
        np.testing.assert_array_equal(p, w[a:b])
        np.testing.assert_array_equal(q, w[a:b])
    jdepth, _, jflags = (np.asarray(x) for x in jupdate_depth(
        keyframe, refs, jnp.asarray(age[a:b]), jnp.asarray(prior[a:b]),
        jnp.asarray(variance[a:b]), jparams, row_offset=a))
    depth, var, flags = block
    assert np.mean(flags == jflags) >= 0.995, np.mean(flags == jflags)
    both = (flags == 0) & (jflags == 0)
    assert both.any()
    rel = np.abs(depth - jdepth)[both] / jdepth[both]
    assert np.median(rel) <= 5e-5, np.median(rel)


def test_frame_normalize_unnormalize(scene):
    """``normalize`` and ``unnormalize`` of a frame equal JAX's exactly on
    seeded pixel coordinates."""
    keyframe, _, _ = scene
    us = np.random.default_rng(9).uniform(-5, 85, (200, 2)).astype(
        np.float32)
    frame = interop.frame_from_numpy(*keyframe)
    xs = normalize(frame, torch.from_numpy(us)).numpy()
    np.testing.assert_array_equal(xs, np.asarray(jnormalize(keyframe, us)))
    np.testing.assert_array_equal(
        unnormalize(frame, torch.from_numpy(xs)).numpy(),
        np.asarray(junnormalize(keyframe, xs)))


def test_fusion_maps():
    """``fusion_maps`` equals JAX's exactly on seeded maps."""
    gen = np.random.default_rng(10)
    mu1, mu2 = gen.uniform(0.02, 0.5, (2, 12, 16)).astype(np.float32)
    var1, var2 = gen.uniform(1e-4, 0.1, (2, 12, 16)).astype(np.float32)
    port = fusion_maps(*(torch.from_numpy(x) for x in (mu1, mu2, var1, var2)))
    ref = jfusion_maps(*(jnp.asarray(x) for x in (mu1, mu2, var1, var2)))
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
