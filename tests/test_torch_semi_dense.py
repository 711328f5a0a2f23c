"""Parity of the port's semi-dense map maintenance with the JAX package,
on the CPU: age, propagation, regularization, fusion, hypothesis checks
and the sweep's postprocess.  Inputs are seeded numpy arrays and the JAX
package's synthetic renderer.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tadataka_tpu.camera import CameraParameters as JCameraParameters
from tadataka_tpu.core.pose import Pose as JPose
from tadataka_tpu.dataset import PlaneSceneDataset
from tadataka_tpu.vo.semi_dense import (
    increment_age as jincrement_age, propagate as jpropagate,
    regularize as jregularize, SemiDenseParams as JParams)
from tadataka_tpu.vo.semi_dense.estimator import (
    pixel_geometry_map as jpixel_geometry_map)
from tadataka_tpu.vo.semi_dense.fusion import (
    fusion as jfusion, are_statistically_same as jsame)
from tadataka_tpu.vo.semi_dense.hypothesis import (
    clamped_range as jclamped_range, check_args_flag as jcheck_args_flag)
from tadataka_tpu.vo.semi_dense.sweep import postprocess_map as jpostprocess

from tadataka_torch import interop
from tadataka_torch.vo.semi_dense import increment_age, propagate, regularize
from tadataka_torch.vo.semi_dense.estimator import pixel_geometry_map
from tadataka_torch.vo.semi_dense.fusion import fusion, are_statistically_same
from tadataka_torch.vo.semi_dense.hypothesis import (
    clamped_range, check_args_flag)
from tadataka_torch.vo.semi_dense.sweep import postprocess_map

H, W = 48, 64
FOCAL = (50.0, 50.0)


def t(a, dtype=torch.float32):
    return interop.tensor(a, dtype=dtype)


@pytest.fixture(scope="module")
def moving_pair():
    """Frame 0's exact depth map and the relative motion T10 to frame 1."""
    poses = [JPose.identity(),
             JPose.from_rotvec(jnp.float32([0.01, -0.02, 0.005]),
                               jnp.float32([0.3, 0.05, 0.2]))]
    ds = PlaneSceneDataset(n_frames=2, image_shape=(H, W),
                           focal_length=FOCAL, poses=poses,
                           plane_origin=(0.0, 0.0, 8.0),
                           plane_normal=(0.2, -0.1, -1.0))
    f0, f1 = ds[0], ds[1]
    T10 = np.asarray((f1.pose.inv() * f0.pose).T)
    jcam = JCameraParameters.create(FOCAL, (W / 2, H / 2))
    return np.asarray(f0.depth_map), T10, jcam


def port_cam(jcam):
    return interop.camera_from_numpy(jcam.focal_length, jcam.offset)


def test_increment_age_equal(moving_pair):
    """Integer maps: exactly equal, over two rounds."""
    depth, T10, jcam = moving_pair
    cam = port_cam(jcam)
    age0 = np.random.default_rng(1).integers(0, 5, (H, W)).astype(np.int32)
    age1 = increment_age(t(age0, torch.int32), cam, cam, t(T10), t(depth))
    jage1 = np.asarray(jincrement_age(jnp.asarray(age0), jcam, jcam, T10,
                                      depth))
    np.testing.assert_array_equal(age1.numpy(), jage1)
    assert age1.dtype == torch.int32 and jage1.max() == 5
    age2 = increment_age(age1, cam, cam, t(T10), t(depth))
    np.testing.assert_array_equal(
        age2.numpy(), np.asarray(jincrement_age(jage1, jcam, jcam, T10,
                                                depth)))


def test_propagate_matches(moving_pair):
    """The same cells are occupied (exactly); depth and variance within
    1e-5 relative (the precision-weighted sums add in another order)."""
    depth, T10, jcam = moving_pair
    var0 = np.random.default_rng(2).uniform(0.001, 0.1, (H, W)) \
        .astype(np.float32)
    args = (10.0, 1.0, 0.01)
    d1, v1 = propagate(t(T10), port_cam(jcam), port_cam(jcam), t(depth),
                       t(var0), *args)
    jd1, jv1 = (np.asarray(x) for x in jpropagate(
        T10, jcam, jcam, depth, var0, *args))
    np.testing.assert_array_equal(d1.numpy() == 10.0, jd1 == 10.0)
    np.testing.assert_allclose(d1.numpy(), jd1, rtol=1e-5)
    np.testing.assert_allclose(v1.numpy(), jv1, rtol=1e-5)


def test_propagate_collisions_match():
    """Compatible hypotheses fuse, an incompatible farther one loses, and
    untouched cells take the defaults, as in the JAX package: source
    pixels x = 0..3 land on cells [0, 0, 1, 1]."""
    jcam0 = JCameraParameters.create((3.0, 3.0), (0.0, 0.0))
    jcam1 = JCameraParameters.create((1.0, 1.0), (0.0, 0.0))
    depth0 = np.float32([[10.0, 10.5, 5.0, 50.0]])
    var0 = np.full((1, 4), 1e-4, np.float32)
    d1, v1 = propagate(torch.eye(4), port_cam(jcam0), port_cam(jcam1),
                       t(depth0), t(var0), 7.0, 0.5, 0.0)
    jd1, jv1 = jpropagate(jnp.eye(4), jcam0, jcam1, depth0, var0, 7.0, 0.5,
                          0.0)
    np.testing.assert_allclose(d1.numpy(), np.asarray(jd1), rtol=1e-6)
    np.testing.assert_allclose(v1.numpy(), np.asarray(jv1), rtol=1e-6)
    np.testing.assert_allclose(d1.numpy()[0, 1], 5.0, rtol=1e-6)


def test_regularize_matches():
    gen = np.random.default_rng(3)
    depth = (10.0 + gen.normal(0, 0.5, (H, W))).astype(np.float32)
    variance = gen.uniform(0.01, 0.2, (H, W)).astype(np.float32)
    flags = np.where(gen.random((H, W)) < 0.7, 0, -6).astype(np.int32)
    out = regularize(t(depth), t(variance), t(flags, torch.int32))
    ref = jregularize(depth, variance, flags)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)


def test_fusion_and_statistical_sameness():
    gen = np.random.default_rng(4)
    mu1, mu2 = gen.uniform(0.02, 0.5, (2, 200)).astype(np.float32)
    v1, v2 = gen.uniform(1e-4, 1e-2, (2, 200)).astype(np.float32)
    for port, ref in zip(fusion(t(mu1), t(mu2), t(v1), t(v2)),
                         jfusion(mu1, mu2, v1, v2)):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-6)
    np.testing.assert_array_equal(
        are_statistically_same(t(mu1), t(mu2), t(v1), t(v2)).numpy(),
        np.asarray(jsame(mu1, mu2, v1, v2)))


def test_hypothesis_range_and_flags():
    gen = np.random.default_rng(5)
    inv = gen.uniform(-0.1, 0.7, 500).astype(np.float32)
    var = gen.uniform(0.0, 0.2, 500).astype(np.float32)
    q0, q1 = np.float32(0.02), np.float32(0.5)
    for port, ref in zip(clamped_range(t(inv), t(var), t(q0), t(q1)),
                         jclamped_range(inv, var, q0, q1)):
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    flag = check_args_flag(t(inv), t(var), t(q0), t(q1))
    jflag = np.asarray(jcheck_args_flag(inv, var, q0, q1))
    np.testing.assert_array_equal(flag.numpy(), jflag)
    assert flag.dtype == torch.int32 and len(np.unique(jflag)) == 3


@pytest.mark.parametrize("fuse_prior", [False, True])
def test_postprocess_map_matches(moving_pair, fuse_prior):
    """Depth, variance and flags of the sweep's stage C from the same
    matched inverse depths: flags equal, values within 2e-5 relative."""
    depth, T10, jcam = moving_pair
    gen = np.random.default_rng(6)
    N = H * W
    jparams = JParams.create(2.0, 50.0, ref_step_size=0.002,
                             min_gradient=0.01)
    params = interop.params_from_numpy(jparams)
    us_x = np.tile(np.arange(W, dtype=np.float32), H)
    us_y = np.repeat(np.arange(H, dtype=np.float32), W)
    p_inv = (1.0 / depth.ravel() * gen.uniform(0.9, 1.1, N)) \
        .astype(np.float32)
    p_var = gen.uniform(1e-4, 1e-2, N).astype(np.float32)
    e_key = np.float32([1.5, 0.25])
    geo_args = (us_x, us_y, p_inv, p_var, T10, e_key, jcam.focal_length,
                jcam.offset, (H, W), jcam.focal_length, jcam.offset, (H, W))
    jgeo = jpixel_geometry_map(*geo_args, jparams, 64)
    geo = pixel_geometry_map(*(t(a) if isinstance(a, np.ndarray)
                               or not isinstance(a, tuple) else a
                               for a in geo_args), params, 64)
    q_m = (p_inv * gen.uniform(0.95, 1.05, N)).astype(np.float32)
    nomatch = gen.random(N) < 0.05
    kgrad, gx, gy = gen.normal(0.0, 0.3, (3, N)).astype(np.float32)
    kgrad = np.abs(kgrad)
    ks = np.asarray(jgeo.key_step_size)
    age = gen.integers(0, 3, N).astype(np.int32)
    out = postprocess_map(t(q_m), t(nomatch, torch.bool), t(kgrad), t(ks),
                          t(gx), t(gy), geo, t(p_inv), t(p_var), t(T10),
                          t(age, torch.int32), params=params,
                          fuse_prior=fuse_prior)
    ref = jpostprocess(q_m, nomatch, kgrad, ks, gx, gy, jgeo, p_inv, p_var,
                       T10, age, params=jparams, fuse_prior=fuse_prior)
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    assert np.mean(np.asarray(ref[2]) == 0) > 0.1
    for port, r in zip(out[:2], ref[:2]):
        np.testing.assert_allclose(port.numpy(), np.asarray(r), rtol=2e-5)
