"""Parity of the port's geometry core with the JAX package, on the CPU.

The same numpy inputs (from a seeded generator) go through each JAX
function and its ``tadataka_torch`` counterpart.  Tolerances are float32
ones: both sides compute in float32, in orders that may differ by an ulp
or two per operation.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tadataka_tpu.camera import CameraParameters as JCameraParameters
from tadataka_tpu.camera import CameraModel as JCameraModel
from tadataka_tpu.camera import FOV, resize as jresize
from tadataka_tpu.core import se3 as jse3, so3 as jso3
from tadataka_tpu.core import transforms as jtf
from tadataka_tpu.core.coordinates import image_coordinates as jcoords
from tadataka_tpu.core.gradients import (
    sobel_x as jsobel_x, sobel_y as jsobel_y, np_gradient_2d as jnpgrad)
from tadataka_tpu.core.interpolation import interpolate as jinterpolate
from tadataka_tpu.core.pose import Pose as JPose
from tadataka_tpu.core.warp import warp2d as jwarp2d
from tadataka_tpu.core.warp2pass import (
    homography_warp as jhomography_warp,
    displacement_warp as jdisplacement_warp)
from tadataka_tpu.vo.dvo import _resize_image as jresize_image

from tadataka_torch import interop
from tadataka_torch.camera import CameraModel, resize
from tadataka_torch.camera import FOV as PortFOV
from tadataka_torch.core import se3, so3, transforms as tf
from tadataka_torch.core.coordinates import image_coordinates
from tadataka_torch.core.gradients import sobel_x, sobel_y, np_gradient_2d
from tadataka_torch.core.interpolation import interpolate
from tadataka_torch.core.pose import Pose
from tadataka_torch.core.warp import warp2d
from tadataka_torch.core.warp2pass import homography_warp, displacement_warp
from tadataka_torch.vo.dvo import pyramid_shape, resize_image

F32_RTOL, F32_ATOL = 1e-5, 1e-6


def t(a):
    return interop.tensor(a)


def close(port, ref, rtol=F32_RTOL, atol=F32_ATOL):
    np.testing.assert_allclose(interop.to_numpy(port), np.asarray(ref),
                               rtol=rtol, atol=atol)


@pytest.fixture
def gen():
    return np.random.default_rng(20261016)


def random_rotvecs(gen):
    """Rotation vectors over both branches: zero, below the 1e-5 Taylor
    switchover, small and large angles."""
    big = gen.normal(size=(6, 3)).astype(np.float32)
    tiny = (gen.normal(size=(3, 3)) * 1e-6).astype(np.float32)
    return np.concatenate([np.zeros((1, 3), np.float32), tiny, big * 0.01,
                           big])


def test_motion_matrix_and_inverse(gen):
    R = np.asarray(jso3.exp_so3(jnp.asarray(random_rotvecs(gen))))
    tr = gen.normal(size=(R.shape[0], 3)).astype(np.float32)
    close(tf.motion_matrix(t(R), t(tr)), jtf.motion_matrix(R, tr))
    T = np.asarray(jtf.motion_matrix(R, tr))
    close(tf.inv_motion_matrix(t(T)), jtf.inv_motion_matrix(T))
    close(tf.get_rotation(t(T)), jtf.get_rotation(T), atol=0)
    close(tf.get_translation(t(T)), jtf.get_translation(T), atol=0)


@pytest.mark.parametrize("fn", ["exp_so3", "hat_so3"])
def test_so3_maps(gen, fn):
    rv = random_rotvecs(gen)
    close(getattr(so3, fn)(t(rv)), getattr(jso3, fn)(rv))


def test_log_so3(gen):
    R = np.asarray(jso3.exp_so3(jnp.asarray(random_rotvecs(gen))))
    close(so3.log_so3(t(R)), jso3.log_so3(R), atol=2e-6)


@pytest.mark.parametrize("fn", ["exp_se3", "exp_se3_t"])
def test_se3_exp(gen, fn):
    """The port has no 4x4 ``exp_se3``: ``Pose.from_se3(xi).T`` stands in
    for it, and ``exp_se3_t`` is its translation."""
    xi = np.concatenate([gen.normal(size=(16, 3)).astype(np.float32),
                         random_rotvecs(gen)], axis=1)
    port = {"exp_se3": lambda x: Pose.from_se3(x).T,
            "exp_se3_t": se3.exp_se3_t}[fn]
    close(port(t(xi)), getattr(jse3, fn)(xi), atol=2e-6)


def test_se3_exp_small_angles(gen):
    """Both branches of the left Jacobian near the 1e-5 Taylor
    switchover (below it, at it, just above it)."""
    axes = gen.normal(size=(12, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles = np.concatenate([[0.0, 1e-7, 3e-6, 9.9e-6, 1e-5, 1.01e-5],
                             gen.uniform(2e-5, 1e-3, 6)])
    rv = (axes * angles[:, None]).astype(np.float32)
    xi = np.concatenate([gen.normal(size=(12, 3)).astype(np.float32), rv],
                        axis=1)
    close(se3.exp_se3_t(t(xi)), jse3.exp_se3_t(xi), atol=2e-6)


def test_pose_ops(gen):
    xi = np.concatenate([gen.normal(size=(16, 3)).astype(np.float32),
                         random_rotvecs(gen)], axis=1)
    jp = JPose.from_se3(jnp.asarray(xi))
    tp = Pose.from_se3(t(xi))
    close(tp.R, jp.R, atol=2e-6)
    close(tp.t, jp.t, atol=2e-6)
    close(tp.inv().T, jp.inv().T, atol=2e-6)
    close((tp * tp.inv()).T, (jp * jp.inv()).T, atol=1e-5)
    rv, tr = random_rotvecs(gen)[5], np.float32([0.3, -0.2, 1.0])
    close(Pose.from_rotvec(t(rv), t(tr)).T,
          JPose.from_rotvec(jnp.asarray(rv), jnp.asarray(tr)).T)
    close(Pose.identity().T, JPose.identity().T, atol=0)


def test_image_coordinates_and_warp2d(gen):
    H, W = 12, 17
    close(image_coordinates((H, W)), jcoords((H, W)), atol=0)
    jcam = JCameraParameters.create((20.0, 22.0), (8.0, 6.5))
    cam = interop.camera_from_numpy(jcam.focal_length, jcam.offset)
    rv = np.float32([0.02, -0.03, 0.01])
    T = np.asarray(JPose.from_rotvec(jnp.asarray(rv),
                                     jnp.float32([0.1, 0.05, -0.2])).T)
    us = np.asarray(jcoords((H, W)))
    depth = gen.uniform(1.0, 20.0, H * W).astype(np.float32)
    u1, d1 = warp2d(t(T), cam, cam, t(us), t(depth))
    ju1, jd1 = jwarp2d(T, jcam, jcam, us, depth)
    close(u1, ju1, atol=1e-4)
    close(d1, jd1)


def test_interpolate(gen):
    image = gen.random((9, 13)).astype(np.float32)
    coords = np.concatenate([
        gen.uniform(-2.0, 15.0, (200, 2)),          # in and out of range
        gen.integers(0, 9, (20, 2)),                # exact integers
    ]).astype(np.float32)
    close(interpolate(t(image), t(coords)), jinterpolate(image, coords))


@pytest.mark.parametrize("which", ["sobel_x", "sobel_y", "np_gradient"])
def test_gradients(gen, which):
    image = gen.random((11, 14)).astype(np.float32)
    if which == "np_gradient":
        for port, ref in zip(np_gradient_2d(t(image)), jnpgrad(image)):
            close(port, ref)
        return
    port = {"sobel_x": sobel_x, "sobel_y": sobel_y}[which]
    ref = {"sobel_x": jsobel_x, "sobel_y": jsobel_y}[which]
    close(port(t(image)), ref(image, mode="zero"))


def near_identity_homographies(gen, n):
    Hs = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    Hs[:, :2, :2] += gen.normal(scale=0.02, size=(n, 2, 2))
    Hs[:, :2, 2] += gen.normal(scale=3.0, size=(n, 2))
    Hs[:, 2, :2] += gen.normal(scale=2e-4, size=(n, 2))
    return Hs.astype(np.float32)


def test_homography_warp_batched_matches_per_plane(gen):
    """The port warps a batch of homographies at once; each plane equals
    the JAX single-homography warp."""
    img = gen.random((24, 40)).astype(np.float32)
    Hs = near_identity_homographies(gen, 4)
    out, valid = homography_warp(t(img), t(Hs), fill=-1.0)
    for s in range(Hs.shape[0]):
        ref, ref_valid = jhomography_warp(img, jnp.asarray(Hs[s]), fill=-1.0)
        np.testing.assert_array_equal(valid[s].numpy(),
                                      np.asarray(ref_valid))
        close(out[s], ref, atol=2e-6)


def test_displacement_warp(gen):
    img = gen.random((20, 30)).astype(np.float32)
    dx = gen.normal(scale=1.5, size=img.shape).astype(np.float32)
    dy = gen.normal(scale=1.5, size=img.shape).astype(np.float32)
    out, valid = displacement_warp(t(img), t(dx), t(dy))
    ref, ref_valid = jdisplacement_warp(img, dx, dy)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    close(out, ref)


def test_camera_normalize_and_resize(gen):
    jcam = JCameraParameters.create((480.0, 470.0), (320.0, 240.0))
    cam = interop.camera_from_numpy(jcam.focal_length, jcam.offset)
    ux, uy = (gen.uniform(0, 640, 50).astype(np.float32) for _ in range(2))
    jcm, cm = JCameraModel.create(jcam), CameraModel.create(cam)
    for port, ref in zip(cm.normalize_xy(t(ux), t(uy)),
                         jcm.normalize_xy(ux, uy)):
        close(port, ref)
    for port, ref in zip(cm.unnormalize_xy(t(ux), t(uy)),
                         jcm.unnormalize_xy(ux, uy)):
        close(port, ref)
    scale = 1.0 / 1.5 ** 3
    close(resize(cm, scale).camera_parameters.focal_length,
          jresize(jcm, scale).camera_parameters.focal_length)
    close(resize(cm, scale).camera_parameters.offset,
          jresize(jcm, scale).camera_parameters.offset)


def test_camera_model_refuses_unported_distortion(gen):
    """Named for the refusal it replaced: ``CameraModel.create`` now takes
    a FOV distortion, and the camera normalizes and unnormalizes as the
    JAX FOV camera does (within 1e-5 relative: tan and atan may round an
    ulp apart)."""
    jcam = JCameraParameters.create((480.0, 470.0), (320.0, 240.0))
    jcm = JCameraModel.create(jcam, FOV.create(0.1))
    cm = CameraModel.create(
        interop.camera_from_numpy(jcam.focal_length, jcam.offset),
        PortFOV.create(0.1))
    ux, uy = (gen.uniform(0, 640, 50).astype(np.float32) for _ in range(2))
    for port, ref in zip(cm.normalize_xy(t(ux), t(uy)),
                         jcm.normalize_xy(ux, uy)):
        close(port, ref)
    xn, yn = (np.array(v) for v in jcm.normalize_xy(ux, uy))
    for port, ref in zip(cm.unnormalize_xy(t(xn), t(yn)),
                         jcm.unnormalize_xy(xn, yn)):
        close(port, ref, atol=1e-4)


@pytest.mark.parametrize("level", [0, 1, 2, 3, 4])
def test_pyramid_resize_matches_jax_image_resize(gen, level):
    """The separable antialiased triangle resize against
    jax.image.resize(..., "linear") at the five DVO pyramid shapes of a
    480x640 frame: within 5e-6 on values in [0, 1] (float32 matrix
    products summed in another order)."""
    image = gen.random((480, 640)).astype(np.float32)
    shape = pyramid_shape(image.shape, level, 1.5)
    ref = np.asarray(jax.jit(jresize_image, static_argnums=1)(image, shape))
    close(resize_image(t(image), shape), ref, rtol=0, atol=5e-6)


@pytest.mark.parametrize("out_shape", [(18, 30), (30, 52)])
def test_homography_warp_out_shape(gen, out_shape):
    """``out_shape`` sets the output grid, as in the JAX warp: the same
    valid lanes, values within 2e-6."""
    img = gen.random((24, 40)).astype(np.float32)
    H33 = near_identity_homographies(gen, 1)[0]
    out, valid = homography_warp(t(img), t(H33), out_shape, fill=-1.0)
    ref, ref_valid = jhomography_warp(img, jnp.asarray(H33), out_shape,
                                      fill=-1.0)
    assert tuple(out.shape) == out_shape
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    close(out, ref, atol=2e-6)
    whole, _ = homography_warp(t(img), t(H33))
    same = homography_warp(t(img), t(H33), tuple(img.shape))[0]
    assert torch.equal(whole, same)


def test_camera_matrix_and_warp_constants():
    """``CameraParameters.matrix`` equals the JAX property; the warp
    modules' EPSILON is the JAX package's."""
    from tadataka_tpu.core import shiftwarp as jshiftwarp
    from tadataka_tpu.core import warp2pass as jwarp2pass
    from tadataka_torch.camera import CameraParameters
    from tadataka_torch.core import shiftwarp, warp2pass
    jcam = JCameraParameters.create((480.0, 470.0), (320.5, 240.25))
    cam = CameraParameters.create((480.0, 470.0), (320.5, 240.25))
    np.testing.assert_array_equal(cam.matrix.numpy(), np.asarray(jcam.matrix))
    assert warp2pass.EPSILON == jwarp2pass.EPSILON
    assert shiftwarp.EPSILON == jshiftwarp.EPSILON
