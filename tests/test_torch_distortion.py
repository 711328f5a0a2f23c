"""Parity of the port's FOV and RadTan distortions and camera models with
the JAX package on the CPU: packed and componentwise forms, the r ~ 0
and omega ~ 0 guards, distort/undistort round trips, and the text form.

Tolerances: the closed forms agree within a few float32 ulps (rtol 1e-5,
atol 1e-6: ``tan``/``atan`` and the norm's root round by library); the
Newton undistort may stop one step apart in a lane, so it is held within
atol 2e-6 on coordinates of size up to ~1.  Round trips hold within 1e-5
(RadTan's convergence threshold is a squared step of 1e-10).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tadataka_tpu.camera import CameraModel as JCameraModel
from tadataka_tpu.camera import CameraParameters as JCameraParameters
from tadataka_tpu.camera import FOV as JFOV, RadTan as JRadTan
from tadataka_tpu.camera import NoDistortion as JNoDistortion
from tadataka_tpu.dataset.tum_rgbd import get_camera_model_rgb as jfreiburg

from tadataka_torch import interop
from tadataka_torch.camera import (
    FOV, CameraModel, CameraParameters, NoDistortion, RadTan)
from tadataka_torch.dataset.tum_rgbd import get_camera_model_rgb

RTOL, ATOL = 1e-5, 1e-6
FREIBURG1 = [0.2624, -0.9531, -0.0054, 0.0026, 1.1633]


def points(seed=0, n=400, scale=0.6):
    """Normalized points, with the origin and lanes below the r ~ 0
    guard."""
    gen = np.random.default_rng(seed)
    x = gen.uniform(-scale, scale, (n, 2)).astype(np.float32)
    x[:3] = [[0.0, 0.0], [1e-9, 0.0], [3e-9, -2e-9]]
    return x


def models(kind):
    """(port model, JAX model) pairs."""
    if kind == "fov":
        return FOV.create(0.4), JFOV.create(0.4)
    if kind == "fov_zero":                       # the omega ~ 0 bypass
        return FOV.create(0.0), JFOV.create(0.0)
    if kind == "radtan":
        return RadTan.create(FREIBURG1), JRadTan.create(FREIBURG1)
    if kind == "radtan4":                        # padded to five
        return (RadTan.create([-0.28, 0.07, 2e-4, 1e-5]),
                JRadTan.create([-0.28, 0.07, 2e-4, 1e-5]))
    return NoDistortion(), JNoDistortion()


KINDS = ["fov", "fov_zero", "radtan", "radtan4", "none"]


def close(port, ref, atol=ATOL):
    np.testing.assert_allclose(interop.to_numpy(port), np.asarray(ref),
                               rtol=RTOL, atol=atol)


@pytest.mark.parametrize("kind", KINDS)
def test_distort_packed_and_componentwise(kind):
    model, jmodel = models(kind)
    x = points()
    close(model.distort(torch.from_numpy(x)), jmodel.distort(jnp.asarray(x)))
    for port, ref in zip(model.distort_xy(*torch.from_numpy(x).T),
                         jmodel.distort_xy(*jnp.asarray(x).T)):
        close(port, ref)


@pytest.mark.parametrize("kind", KINDS)
def test_undistort_packed_and_componentwise(kind):
    model, jmodel = models(kind)
    x = points(1, scale=0.5)
    atol = 2e-6 if kind.startswith("radtan") else ATOL
    close(model.undistort(torch.from_numpy(x)),
          jmodel.undistort(jnp.asarray(x)), atol=atol)
    for port, ref in zip(model.undistort_xy(*torch.from_numpy(x).T),
                         jmodel.undistort_xy(*jnp.asarray(x).T)):
        close(port, ref, atol=atol)


@pytest.mark.parametrize("kind", KINDS)
def test_round_trips(kind):
    """undistort(distort(x)) = x and distort(undistort(x)) = x within
    1e-5."""
    model, _ = models(kind)
    x = torch.from_numpy(points(2, scale=0.45))
    np.testing.assert_allclose(model.undistort(model.distort(x)).numpy(),
                               x.numpy(), atol=1e-5)
    np.testing.assert_allclose(model.distort(model.undistort(x)).numpy(),
                               x.numpy(), atol=1e-5)


def test_radtan_max_iter_and_threshold():
    """A capped Newton loop (2 steps) and a loose threshold stop where the
    JAX loop stops."""
    model, jmodel = models("radtan")
    x = points(3)
    for kw in (dict(max_iter=2), dict(threshold=1e-4)):
        for port, ref in zip(model.undistort_xy(*torch.from_numpy(x).T, **kw),
                             jmodel.undistort_xy(*jnp.asarray(x).T, **kw)):
            close(port, ref, atol=2e-6)


@pytest.mark.parametrize("kind", ["fov", "radtan", "none"])
def test_camera_model_and_text_form(kind):
    """A CameraModel normalizes and unnormalizes as JAX's; its text form
    equals JAX's, and ``fromstring`` reads it back (also from JAX's)."""
    model, jmodel = models(kind)
    f, c = (517.3, 516.5), (318.6, 255.3)
    cm = CameraModel.create(CameraParameters.create(f, c), model)
    jcm = JCameraModel.create(JCameraParameters.create(f, c), jmodel)
    gen = np.random.default_rng(4)
    us = gen.uniform(0, 640, (300, 2)).astype(np.float32)
    atol = 2e-6 if kind == "radtan" else ATOL
    close(cm.normalize(torch.from_numpy(us)), jcm.normalize(jnp.asarray(us)),
          atol=atol)
    for port, ref in zip(cm.normalize_xy(*torch.from_numpy(us).T),
                         jcm.normalize_xy(*jnp.asarray(us).T)):
        close(port, ref, atol=atol)
    xs = np.array(jcm.normalize(jnp.asarray(us)))
    close(cm.unnormalize(torch.from_numpy(xs)), jcm.unnormalize(xs),
          atol=1e-4)
    assert str(cm) == str(jcm)
    for text in (str(cm), str(jcm)):
        back = CameraModel.fromstring(text)
        assert type(back.distortion_model) is type(model)
        assert str(back) == str(cm)
    with pytest.raises(ValueError, match="Unknown distortion"):
        CameraModel.fromstring("Fisheye 1 1 0 0")


def test_freiburg_camera_and_interop():
    """The freiburg1 RGB camera of the TUM loader, and
    ``interop.camera_model_from_numpy`` carrying a JAX camera of each
    distortion kind, normalize as the JAX cameras do."""
    us = np.random.default_rng(5).uniform(0, 640, (300, 2)).astype(
        np.float32)
    jcms = [jfreiburg(1),
            JCameraModel.create(JCameraParameters.create((300., 310.),
                                                         (160., 120.)),
                                JFOV.create(0.3)),
            JCameraModel.create(JCameraParameters.create((300., 310.),
                                                         (160., 120.)))]
    ports = [get_camera_model_rgb(1)] + [
        interop.camera_model_from_numpy(
            j.camera_parameters.focal_length, j.camera_parameters.offset,
            type(j.distortion_model).__name__, j.distortion_model.params)
        for j in jcms]
    for cm, jcm in zip(ports, jcms[:1] + jcms):
        assert str(cm) == str(jcm)
        close(cm.normalize(torch.from_numpy(us)),
              jcm.normalize(jnp.asarray(us)), atol=2e-6)
    with pytest.raises(ValueError, match="Unknown distortion"):
        interop.camera_model_from_numpy((1, 1), (0, 0), "Fisheye")
