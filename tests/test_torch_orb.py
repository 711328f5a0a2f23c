"""The port's ORB (``features/orb.py``) against the JAX package's, on
the CPU, on ``tests/features/test_orb.py``'s inputs: a 96x96 smoothed
noise image and a 31x31 half-bright patch.

- The sampling pattern and the disk offsets are equal (both computed on
  the host with numpy, ``default_rng(7)``).
- The orientation: the port sums the disk's moments pairwise in a fixed
  order and takes ``rounding.atan2``, the JAX package sums in XLA's
  order: the angles agree within 2e-5 rad.
- The descriptors: a bit can differ only where one of its two rotated
  samples lies within rounding of a pixel boundary (x.5), where the
  angles' last bits choose the pixel.  Such samples (those within 1e-4
  px of a boundary, on JAX's angle) are counted and set aside; every
  other bit, and every validity flag, is equal.
- FAST keypoints and masks are bit-equal (``features/detector.py``).
"""

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

import jax.numpy as jnp

from tadataka_tpu.features import orb as jorb
from tadataka_torch.features import orb


def T(a, dtype=torch.float32):
    return torch.tensor(np.array(a), dtype=dtype)


@pytest.fixture(scope="module")
def textured():
    g = np.random.default_rng(20261017)
    return gaussian_filter(g.uniform(0, 1, (96, 96)).astype(np.float32),
                           2.0).astype(np.float32)


def test_pattern_and_disk():
    for a, b in zip(orb._gaussian_pattern(), jorb._gaussian_pattern()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(orb._disk_offsets(), jorb._disk_offsets())
    assert len(orb._disk_offsets()) == 149


def test_corner_orientations(textured):
    g = np.random.default_rng(1)
    kps = g.uniform(0, 95, (200, 2)).astype(np.float32)
    out = orb.corner_orientations(T(textured), T(kps)).numpy()
    ref = np.asarray(jorb.corner_orientations(jnp.asarray(textured),
                                              jnp.asarray(kps)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-5)
    half = np.zeros((31, 31), np.float32)
    half[:, 16:] = 1.0
    kp = np.array([[15.0, 15.0]], np.float32)
    for image, angle in ((half, 0.0), (half.T, np.pi / 2)):
        theta = orb.corner_orientations(T(image), T(kp)).numpy()
        assert abs(theta[0] - angle) < 0.05
        assert theta[0] == np.asarray(jorb.corner_orientations(
            jnp.asarray(image), jnp.asarray(kp)))[0]


def boundary_samples(kps, theta, patch_size=32):
    """(K, D) mask of the bits with a rotated sample within 1e-4 px of a
    rounding boundary, on the angles theta (float64)."""
    near = None
    for pos in jorb._gaussian_pattern(256, patch_size):
        c = np.cos(theta)[:, None]
        s = np.sin(theta)[:, None]
        x = kps[:, 0:1] + c * pos[None, :, 0] - s * pos[None, :, 1]
        y = kps[:, 1:2] + s * pos[None, :, 0] + c * pos[None, :, 1]
        m = ((np.abs(x - np.floor(x) - 0.5) < 1e-4)
             | (np.abs(y - np.floor(y) - 0.5) < 1e-4))
        near = m if near is None else near | m
    return near


def assert_bits_equal(out, ref, kps):
    bits, valid, theta = (x.numpy() for x in out)
    jbits, jvalid, jtheta = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(valid, jvalid)
    np.testing.assert_allclose(theta, jtheta, rtol=0, atol=2e-5)
    near = boundary_samples(kps.astype(np.float64), jtheta.astype(np.float64))
    assert near.mean() < 0.01
    np.testing.assert_array_equal(bits[~near], jbits[~near])
    return int(near.sum())


def test_orb_descriptors(textured):
    g = np.random.default_rng(2)
    kps = g.uniform(16, 79, (80, 2)).astype(np.float32)
    kps[:20] = np.round(kps[:20])
    mask = np.ones(80, bool)
    mask[::7] = False
    out = orb.orb_descriptors(T(textured), T(kps), T(mask, torch.bool))
    ref = jorb.orb_descriptors(jnp.asarray(textured), jnp.asarray(kps),
                               jnp.asarray(mask))
    assert_bits_equal(out, ref, kps)
    assert out[1].sum() > 50


def test_orb_rotation_invariance(textured):
    """As the JAX package's test: steered BRIEF keeps most bits under a
    90-degree rotation of the image."""
    g = np.random.default_rng(3)
    h = textured.shape[0]
    kps = g.uniform(25, 70, (30, 2)).astype(np.float32)
    rotated = np.rot90(textured, k=-1).copy()
    kps_rot = np.stack([(h - 1) - kps[:, 1], kps[:, 0]], axis=-1)
    mask = torch.ones(len(kps), dtype=torch.bool)
    d0, v0, _ = orb.orb_descriptors(T(textured), T(kps), mask)
    d1, v1, _ = orb.orb_descriptors(T(rotated), T(kps_rot), mask)
    valid = (v0 & v1).numpy()
    agree = (d0.numpy() == d1.numpy()).mean(axis=1)
    assert valid.sum() >= 20
    assert agree[valid].mean() > 0.8


def test_extract_orb_features(textured):
    out = orb.extract_orb_features(T(textured), max_keypoints=128,
                                   threshold=0.02)
    ref = jorb.extract_orb_features(jnp.asarray(textured), max_keypoints=128,
                                    threshold=0.02)
    np.testing.assert_array_equal(out.keypoints.numpy(),
                                  np.asarray(ref.keypoints))
    np.testing.assert_array_equal(out.mask.numpy(), np.asarray(ref.mask))
    assert out.descriptors.shape == (128, 256)
    kps = out.keypoints.numpy()
    theta = np.asarray(jorb.corner_orientations(jnp.asarray(textured),
                                                jnp.asarray(kps)))
    near = boundary_samples(kps.astype(np.float64), theta.astype(np.float64))
    np.testing.assert_array_equal(out.descriptors.numpy()[~near],
                                  np.asarray(ref.descriptors)[~near])
    assert int(out.mask.sum()) > 20
