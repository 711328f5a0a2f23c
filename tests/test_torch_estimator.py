"""Parity of the port's scattered estimator (``estimator.update_depth``)
with the JAX package's, on the CPU: the per-pixel normalized-SSD match
and the whole-map update on a 3-refframe history, with and without the
prior fusion.

Inputs come from seeded numpy generators and the JAX package's renderer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tadataka_tpu.camera import CameraParameters as JCameraParameters
from tadataka_tpu.core.pose import Pose as JPose
from tadataka_tpu.dataset import PlaneSceneDataset
from tadataka_tpu.vo.semi_dense import SemiDenseParams as JParams
from tadataka_tpu.vo.semi_dense import make_frame as jmake_frame
from tadataka_tpu.vo.semi_dense.estimator import (
    _ssd_search as j_ssd_search, update_depth as jupdate_depth)
from tadataka_tpu.vo.semi_dense.frame import stack_frames as jstack

from tadataka_torch import interop
from tadataka_torch.flags import Flag
from tadataka_torch.vo.semi_dense.estimator import _ssd_search, update_depth

H, W = 32, 48
FOCAL = (40.0, 40.0)
PARAMS_ARGS = dict(min_depth=2.0, max_depth=50.0, geo_coeff=0.01,
                   photo_coeff=0.01, ref_step_size=0.002, min_gradient=0.01)


def t(a, dtype=torch.float32):
    return interop.tensor(a, dtype=dtype)


def test_ssd_search_matches_per_pixel():
    """The (S, N) match against JAX's per-pixel ``_ssd_search`` (vmapped)
    on seeded intensities with ragged valid counts and planted ties:
    equal indices everywhere."""
    gen = np.random.default_rng(4)
    S, N = 24, 256
    ref = gen.random((S, N)).astype(np.float32)
    key = ref[7:12].copy()
    ref[:, :32] = 0.5                          # flat lines: every window ties
    ref[15:20, 32:64] = key[:, 32:64]          # a second exact match
    n_valid = gen.integers(0, S + 1, N).astype(np.int32)
    n_valid[32:64] = S
    port = _ssd_search(t(ref), t(key), t(n_valid, torch.int32)).numpy()
    jref = np.asarray(jax.vmap(j_ssd_search, in_axes=(1, 1, 0))(
        jnp.asarray(ref), jnp.asarray(key), jnp.asarray(n_valid)))
    np.testing.assert_array_equal(port, jref)
    assert np.all(port[32:64] == 7 + 2)


@pytest.fixture(scope="module")
def history():
    """A keyframe and a 3-refframe history on a lateral+forward track, a
    prior within 10% of the truth and ages 0-3."""
    poses = [JPose.from_rotvec(jnp.float32([0.0, 0.004 * i, 0.0]),
                               jnp.float32([0.1 * i, 0.01 * i, 0.03 * i]))
             for i in range(4)]
    ds = PlaneSceneDataset(n_frames=4, image_shape=(H, W),
                           focal_length=FOCAL, poses=poses,
                           plane_origin=(0.0, 0.0, 8.0),
                           plane_normal=(0.05, -0.02, -1.0))
    frames = [ds[i] for i in range(4)]
    jcam = JCameraParameters.create(FOCAL, (W / 2, H / 2))
    key = jmake_frame(jcam, frames[3].image, frames[3].pose.T)
    refs = jstack([jmake_frame(jcam, f.image, f.pose.T) for f in frames[:3]])
    gen = np.random.default_rng(6)
    gt = np.asarray(frames[3].depth_map)
    prior_depth = (gt * gen.uniform(0.9, 1.1, gt.shape)).astype(np.float32)
    prior_var = gen.uniform(0.002, 0.02, gt.shape).astype(np.float32)
    age = gen.integers(0, 4, gt.shape).astype(np.int32)
    return key, refs, prior_depth, prior_var, age, gt


@pytest.mark.parametrize("fuse_prior", [False, True])
def test_update_depth_matches(history, fuse_prior):
    """Flags agree on >= 99.5% of pixels; on pixels SUCCESS on both the
    relative depth difference has median <= 5e-5 (the ceilings of the
    sweep's parity test), and the variances are positive.  (Measured:
    flags equal, median 4e-7.)  The map is a depth estimate: median
    relative error to the truth < 10% (6% measured: one 40-px-focal
    sample step is coarse)."""
    key, refs, prior_depth, prior_var, age, gt = history
    jparams = JParams.create(**PARAMS_ARGS)
    jdepth, jvar, jflags = (np.asarray(x) for x in jupdate_depth(
        key, refs, jnp.asarray(age), jnp.asarray(prior_depth),
        jnp.asarray(prior_var), jparams, fuse_prior=fuse_prior))
    depth, var, flags = interop.to_numpy(update_depth(
        interop.frame_from_numpy(*key), interop.frame_from_numpy(*refs),
        t(age, torch.int32), t(prior_depth), t(prior_var),
        interop.params_from_numpy(jparams), fuse_prior=fuse_prior))
    assert np.mean(flags == jflags) >= 0.995, np.mean(flags == jflags)
    both = (flags == 0) & (jflags == 0)
    assert both.mean() > 0.05, both.mean()
    rel = np.abs(depth - jdepth)[both] / jdepth[both]
    assert np.median(rel) <= 5e-5, np.median(rel)
    assert np.all(np.isfinite(depth)) and np.all(var > 0)
    assert np.all(flags[age == 0] == int(Flag.NOT_PROCESSED))
    assert np.median(np.abs(depth - gt)[both] / gt[both]) < 0.1
