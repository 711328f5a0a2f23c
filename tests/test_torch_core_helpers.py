"""The geometry-core helpers of the port (SE(3) exp / log, ``Pose``'s
``rotvec`` / ``se3`` / ``apply`` / ``isclose``, ``is_rotation_matrix``,
the three warp classes, ``interpolate_checked``, ``all_in_image_range``,
the reflect-border gradients, the coordinate helpers, the flag helpers,
DVO's ``calc_jacobian`` and ``PlaneScene``) against the JAX package's,
on the CPU, on seeded numpy inputs.  Tolerances are float32 ones (a few
ulps of the values compared); integer and boolean results are equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tadataka_tpu import flags as jflags
from tadataka_tpu.camera import CameraModel as JCameraModel
from tadataka_tpu.camera import CameraParameters as JCameraParameters
from tadataka_tpu.core import coordinates as jcoordinates
from tadataka_tpu.core import gradients as jgradients
from tadataka_tpu.core import se3 as jse3, so3 as jso3
from tadataka_tpu.core import warp as jwarp
from tadataka_tpu.core.image_range import (
    all_in_image_range as jall_in_range)
from tadataka_tpu.core.interpolation import (
    interpolate_checked as jinterpolate_checked)
from tadataka_tpu.core.pose import Pose as JPose
from tadataka_tpu.dataset.synthetic import PlaneScene as JPlaneScene
from tadataka_tpu.vo.dvo import calc_jacobian as jcalc_jacobian

from tadataka_torch import flags
from tadataka_torch import core as port_core
from tadataka_torch.core import coordinates, gradients, se3, so3, warp
from tadataka_torch.core.image_range import all_in_image_range
from tadataka_torch.core.interpolation import interpolate_checked
from tadataka_torch.core.pose import Pose
from tadataka_torch.dataset.synthetic import PlaneScene
from tadataka_torch.interop import camera_model_from_numpy
from tadataka_torch.vo.dvo import calc_jacobian


def T(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


def close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=atol)


@pytest.fixture
def gen():
    return np.random.default_rng(20261017)


def xis(gen, n=64):
    """Twists with rotations up to ~2.5 rad and a few below the Taylor
    switchover."""
    xi = gen.normal(0.0, 0.8, (n, 6)).astype(np.float32)
    xi[:4, 3:] *= 1e-7
    return xi


def test_exp_log_se3(gen):
    """exp_se3 within 4e-7 of JAX's (entries up to ~3); log_se3 of the
    same matrices within 4e-6 (rotations of 2.5 rad amplify rounding)."""
    xi = xis(gen)
    G = jse3.exp_se3(jnp.asarray(xi))
    close(se3.exp_se3(T(xi)), G, 4e-7 * 8)
    close(se3.log_se3(T(G)), jse3.log_se3(G), 4e-6)


def test_pose_helpers(gen):
    """rotvec, se3 (within 4e-6), apply (4e-6 on points up to ~10 m) and
    isclose (the same answer at the tolerance's edge) of the JAX Pose."""
    xi = xis(gen, 8)
    jposes = [JPose.from_se3(jnp.asarray(x)) for x in xi]
    poses = [Pose.from_se3(T(x)) for x in xi]
    P = gen.normal(0.0, 3.0, (50, 3)).astype(np.float32)
    for jp, p in zip(jposes, poses):
        close(p.rotvec, jp.rotvec, 4e-6)
        close(p.se3(), jp.se3(), 4e-6)
        close(p.apply(T(P)), jp.apply(jnp.asarray(P)), 4e-6)
    for dt in (0.0, 5e-6, 2e-5):
        jq = JPose(jposes[0].R, jposes[0].t + dt)
        q = Pose(poses[0].R, poses[0].t + dt)
        assert bool(poses[0].isclose(q)) == bool(jposes[0].isclose(jq)), dt


def test_is_rotation_matrix(gen):
    R = np.asarray(jso3.exp_so3(jnp.asarray(xis(gen, 16)[:, 3:])))
    for M in (R, R * 1.001, R[:, ::-1].copy(), R + 2e-6):
        assert bool(so3.is_rotation_matrix(T(M))) == bool(
            jso3.is_rotation_matrix(jnp.asarray(M)))


def camera_models():
    focal, offset = (100.0, 110.0), (63.5, 47.5)
    jcm = JCameraModel.create(JCameraParameters.create(focal, offset))
    return jcm, camera_model_from_numpy(focal, offset)


def test_warp_classes(gen):
    """Warp3D, Warp2D and LocalWarp2D of two camera -> world poses: pixels
    within 2e-4 px, depths and points within 1e-5 m."""
    jcm, cm = camera_models()
    xi = xis(gen, 2) * 0.2
    jw0, jw1 = (JPose.from_se3(jnp.asarray(x)) for x in xi)
    w0, w1 = (Pose.from_se3(T(x)) for x in xi)
    us = gen.uniform(0, 127, (200, 2)).astype(np.float32)
    depths = gen.uniform(1.0, 8.0, 200).astype(np.float32)
    P = gen.normal(0.0, 2.0, (200, 3)).astype(np.float32)
    close(warp.Warp3D(w0, w1)(T(P)), jwarp.Warp3D(jw0, jw1)(jnp.asarray(P)),
          1e-5)
    for out, ref in [
            (warp.Warp2D(cm, cm, w0, w1)(T(us), T(depths)),
             jwarp.Warp2D(jcm, jcm, jw0, jw1)(jnp.asarray(us),
                                              jnp.asarray(depths))),
            (warp.LocalWarp2D(cm, cm, w1.inv() * w0)(T(us), T(depths)),
             jwarp.LocalWarp2D(jcm, jcm, jw1.inv() * jw0)(
                 jnp.asarray(us), jnp.asarray(depths)))]:
        close(out[0], ref[0], 2e-4)
        close(out[1], ref[1], 1e-5)


def test_interpolate_checked_and_ranges(gen):
    """Values within 1e-6, masks equal, ``fill`` on the lanes out of
    range; ``all_in_image_range`` equal on batches of coordinate sets."""
    image = gen.random((24, 32)).astype(np.float32)
    us = gen.uniform(-2, 34, (300, 2)).astype(np.float32)
    us[:4] = [[0, 0], [31, 23], [31.0001, 5], [-0.0, 23]]
    values, mask = interpolate_checked(T(image), T(us), fill=-1.0)
    jvalues, jmask = jinterpolate_checked(jnp.asarray(image),
                                          jnp.asarray(us), fill=-1.0)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    close(values, jvalues, 1e-6)
    assert (~mask.numpy()).sum() > 20
    sets = us.reshape(30, 10, 2)
    np.testing.assert_array_equal(
        all_in_image_range(T(sets), image.shape).numpy(),
        np.asarray(jall_in_range(jnp.asarray(sets), image.shape)))


def test_reflect_gradients_and_gradient1d(gen):
    """grad_x, grad_y (scipy's reflect Sobel) and gradient1d: the same
    shifted adds in the same order, bit-equal."""
    image = gen.random((19, 23)).astype(np.float32)
    for fn, jfn in ((gradients.grad_x, jgradients.grad_x),
                    (gradients.grad_y, jgradients.grad_y),
                    (gradients.gradient1d, jgradients.gradient1d)):
        np.testing.assert_array_equal(fn(T(image)).numpy(),
                                      np.asarray(jfn(jnp.asarray(image))))


def test_coordinate_helpers(gen):
    grid = coordinates.image_coordinate_grid((5, 7))
    np.testing.assert_array_equal(
        grid.numpy(), np.asarray(jcoordinates.image_coordinate_grid((5, 7))))
    xy = gen.uniform(0, 6.9, (40, 2)).astype(np.float32)
    xy[:, 1] = np.minimum(xy[:, 1], 4.9)
    np.testing.assert_array_equal(
        coordinates.xy_to_yx(T(xy)).numpy(),
        np.asarray(jcoordinates.xy_to_yx(jnp.asarray(xy))))
    assert coordinates.yx_to_xy is coordinates.xy_to_yx
    image = gen.random((5, 7)).astype(np.float32)
    np.testing.assert_array_equal(
        coordinates.get(T(image), T(xy)).numpy(),
        np.asarray(jcoordinates.get(jnp.asarray(image), jnp.asarray(xy))))
    us = np.array([[0, 0], [6, 4], [3, 2]], np.float32)
    vals = np.array([9.0, 8.0, 7.0], np.float32)
    out = coordinates.substitute(T(image), T(us), T(vals))
    np.testing.assert_array_equal(out.numpy(), np.asarray(
        jcoordinates.substitute(jnp.asarray(image), jnp.asarray(us),
                                jnp.asarray(vals))))
    assert out.data_ptr() != T(image).data_ptr()


def test_flag_helpers(gen):
    flag_map = gen.integers(-9, 1, (30, 40)).astype(np.int32)
    np.testing.assert_array_equal(
        flags.success_mask(T(flag_map, torch.int32)).numpy(),
        np.asarray(jflags.success_mask(jnp.asarray(flag_map))))
    np.testing.assert_array_equal(
        flags.flag_histogram(T(flag_map, torch.int32)).numpy(),
        np.asarray(jflags.flag_histogram(jnp.asarray(flag_map))))


def test_calc_jacobian(gen):
    """The (N, 6) rows within 2e-6 relative of JAX's."""
    P = gen.uniform(-1, 1, (100, 3)).astype(np.float32)
    P[:, 2] += 3.0
    gx, gy = gen.normal(0, 1, (2, 100)).astype(np.float32)
    focal = np.array([480.0, 470.0], np.float32)
    out = calc_jacobian(T(focal), T(gx), T(gy), T(P)).numpy()
    ref = np.asarray(jcalc_jacobian(jnp.asarray(focal), jnp.asarray(gx),
                                    jnp.asarray(gy), jnp.asarray(P)))
    np.testing.assert_allclose(out, ref, rtol=2e-6, atol=1e-4)


def test_plane_scene_and_exports():
    """PlaneScene has the JAX fields; the core package exports what the
    JAX core package does."""
    assert PlaneScene._fields == JPlaneScene._fields
    import tadataka_tpu.core as jcore
    names = [n for n in dir(jcore) if not n.startswith("_")
             and not isinstance(getattr(jcore, n), type(jcore))]
    missing = [n for n in names if not hasattr(port_core, n)]
    assert not missing, missing


def test_exp_so3_small_branch(gen):
    """exp_so3_small is exp_so3 where theta < 1e-5: the same values and
    forward-mode derivatives (the Gauss-Newton Jacobian's point, 0, and
    nearby), and JAX's exp_so3 there within 1e-7."""
    rotvecs = np.concatenate([np.zeros((1, 3)), gen.normal(
        0, 1e-6, (20, 3))]).astype(np.float32)
    for r in T(rotvecs):
        assert torch.equal(so3.exp_so3_small(r), so3.exp_so3(r))
        assert torch.equal(torch.func.jacfwd(so3.exp_so3_small)(r),
                           torch.func.jacfwd(so3.exp_so3)(r))
    close(so3.exp_so3_small(T(rotvecs)), jso3.exp_so3(jnp.asarray(rotvecs)),
          1e-7)
