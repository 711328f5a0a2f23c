"""Parity of the port's inverse-compositional DVO with the JAX package on
the CPU: an 80x100 rendered pair, 4 pyramid levels, per-pixel weights
("map") and none, the JAX side with ``sample_budget=0`` (gather
sampling, as on the CPU)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tadataka_tpu.camera import resize as jresize
from tadataka_tpu.core.pose import Pose as JPose
from tadataka_tpu.dataset.synthetic import multi_plane_scene as jscene
from tadataka_tpu.vo.dvo import (
    estimate_pose_pyramid as jestimate, _estimate_level_ic as jlevel,
    _resize_image as jresize_image)

from tadataka_torch import interop
from tadataka_torch.camera import CameraModel, resize
from tadataka_torch.vo.dvo import (
    estimate_pose_pyramid, _estimate_level_ic, pyramid_shape, resize_image)

H, W = 80, 100
FOCAL = (80.0, 80.0)
N_LEVELS = 4


@pytest.fixture(scope="module")
def pair():
    poses = [JPose.identity(),
             JPose.from_rotvec(jnp.float32([0.0, 0.004, 0.002]),
                               jnp.float32([0.15, 0.02, 0.05]))]
    ds = jscene(n_frames=2, image_shape=(H, W), focal_length=FOCAL,
                poses=poses)
    f0, f1 = ds[0], ds[1]
    gen = np.random.default_rng(9)
    D0 = (np.asarray(f0.depth_map)
          * gen.uniform(0.97, 1.03, (H, W))).astype(np.float32)
    weights = (1.0 / gen.uniform(0.01, 1.0, (H, W))).astype(np.float32)
    T10 = np.asarray((f1.pose.inv() * f0.pose).T)
    return (f0.camera_model, np.asarray(f0.image), D0,
            np.asarray(f1.image), weights, T10)


def port_cm(jcm):
    p = jcm.camera_parameters
    return CameraModel.create(interop.camera_from_numpy(p.focal_length,
                                                        p.offset))


def t(a):
    return interop.tensor(a)


def test_each_level_matches_from_the_same_start(pair):
    """Every pyramid level, started from the same pose on both sides:
    rotation within 2e-5 and translation within 1e-4 (float32 normal
    equations summed in another order; here they agree to ~1e-6)."""
    jcm, I0, D0, I1, weights, _ = pair
    cm = port_cm(jcm)
    level_fn = jax.jit(jlevel, static_argnums=(8, 9))
    R = np.eye(3, dtype=np.float32)
    tr = np.zeros(3, np.float32)
    for level in reversed(range(N_LEVELS)):
        scale = 1.0 / 1.5 ** level
        shape = pyramid_shape((H, W), level, 1.5)
        j_in = [np.asarray(jresize_image(x, shape))
                for x in (I0, D0, I1, weights)]
        jR, jt = level_fn(jresize(jcm, scale), jresize(jcm, scale), *j_in,
                          R, tr, 20, "map")
        pR, pt = _estimate_level_ic(
            resize(cm, scale), resize(cm, scale),
            *(resize_image(t(x), shape) for x in (I0, D0, I1, weights)),
            t(R), t(tr), 20, "map")
        np.testing.assert_allclose(pR.numpy(), np.asarray(jR), atol=2e-5)
        np.testing.assert_allclose(pt.numpy(), np.asarray(jt), atol=1e-4)
        R, tr = np.asarray(jR), np.asarray(jt)


@pytest.mark.parametrize("weight_kind", ["map", "none"])
def test_pyramid_matches_and_tracks(pair, weight_kind):
    """The whole pyramid: the port's pose within 5e-4 of the JAX pose,
    and within 10% of the true translation.  Chained, the ~1e-6
    differences at a level's start can move the error-increase stop by
    one iteration (level 1 does here: a 1.1e-4 translation difference),
    so the bound is looser than per level; it is still a sixth of either
    side's distance to the true pose."""
    jcm, I0, D0, I1, weights, T10 = pair
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    jR, jt = jestimate(jcm, jcm, I0, D0, I1, weights, eye, zero, N_LEVELS,
                       20, 1.5, weight_kind, "ic", 0)
    cm = port_cm(jcm)
    R, tr = estimate_pose_pyramid(cm, cm, t(I0), t(D0), t(I1), t(weights),
                                  t(eye), t(zero), N_LEVELS, 20, 1.5,
                                  weight_kind, "ic")
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=5e-4)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jt), atol=5e-4)
    t_true = T10[:3, 3]
    assert np.linalg.norm(tr.numpy() - t_true) < 0.1 * np.linalg.norm(t_true)


def test_unported_options_raise(pair):
    jcm, I0, D0, I1, weights, _ = pair
    cm = port_cm(jcm)
    args = (cm, cm, t(I0), t(D0), t(I1), t(weights), torch.eye(3),
            torch.zeros(3), 2, 5, 1.5)
    with pytest.raises(NotImplementedError, match="FC DVO"):
        estimate_pose_pyramid(*args, "map", "fc")
    with pytest.raises(NotImplementedError, match="robust"):
        estimate_pose_pyramid(*args, "huber", "ic")


def test_five_levels_at_the_slice_geometry():
    """The slice's pyramid depth (5 levels) at a quarter of its size
    (120x160, focal 120), on a step of its trajectory (rotvec (0, 0.006,
    0), t (0.06, 0.006, 0.03)): the port's pose within 5e-4 of the JAX
    pose, as for the 4-level pyramid above."""
    shape, focal = (120, 160), (120.0, 120.0)
    poses = [JPose.identity(),
             JPose.from_rotvec(jnp.float32([0.0, 0.006, 0.0]),
                               jnp.float32([0.06, 0.006, 0.03]))]
    ds = jscene(n_frames=2, image_shape=shape, focal_length=focal,
                poses=poses)
    f0, f1 = ds[0], ds[1]
    gen = np.random.default_rng(5)
    D0 = (np.asarray(f0.depth_map)
          * gen.uniform(0.97, 1.03, shape)).astype(np.float32)
    weights = (1.0 / gen.uniform(0.01, 1.0, shape)).astype(np.float32)
    I0, I1 = np.asarray(f0.image), np.asarray(f1.image)
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    jR, jt = jestimate(f0.camera_model, f0.camera_model, I0, D0, I1, weights,
                       eye, zero, 5, 20, 1.5, "map", "ic", 0)
    cm = port_cm(f0.camera_model)
    R, tr = estimate_pose_pyramid(cm, cm, t(I0), t(D0), t(I1), t(weights),
                                  t(eye), t(zero), 5, 20, 1.5, "map", "ic")
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=5e-4)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jt), atol=5e-4)
