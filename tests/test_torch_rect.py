"""Parity of the port's rectified sweep and its geometry with the JAX
package, on the CPU: the device rectification, the warps of
``core/shiftwarp.py``, the disparity stack and key template, and
``update_depth_rect`` on the lateral scene of tests/vo/test_sweep_rect.py
(both baseline signs).

Inputs come from seeded numpy generators and the JAX package's renderer.
The JAX warps are tent shift sums under a 32-px budget; the port's are
gathers with no budget, so warps are compared where both sides are
valid.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tadataka_tpu.camera import CameraParameters as JCameraParameters
from tadataka_tpu.core.pose import Pose as JPose
from tadataka_tpu.core.shiftwarp import (
    const_shift_cols as jconst_shift_cols, rot_warp as jrot_warp)
from tadataka_tpu.core.transforms import inv_motion_matrix as jinv
from tadataka_tpu.dataset import PlaneSceneDataset
from tadataka_tpu.vo.semi_dense import SemiDenseParams as JParams
from tadataka_tpu.vo.semi_dense import make_frame as jmake_frame
from tadataka_tpu.vo.semi_dense.frame import stack_frames as jstack
from tadataka_tpu.vo.semi_dense.rectify import (
    make_rectification as jmake_rectification)
from tadataka_tpu.vo.semi_dense.sweep_rect import (
    _key_template as j_key_template, _shift_stack as j_shift_stack,
    update_depth_rect as jupdate_depth_rect)

from tadataka_torch import interop
from tadataka_torch.core.rounding import cross3, inv3, norm3
from tadataka_torch.core.shiftwarp import const_shift_cols, rot_warp
from tadataka_torch.core.warp2pass import homography_warp
from tadataka_torch.flags import Flag
from tadataka_torch.vo.semi_dense.rectify import (
    baseline_flip, make_rectification)
from tadataka_torch.vo.semi_dense.sweep_rect import (
    _key_template, _shift_stack, update_depth_rect)

H, W = 64, 128
FOCAL = (120.0, 120.0)
PARAMS_ARGS = dict(min_depth=2.0, max_depth=50.0, geo_coeff=0.01,
                   photo_coeff=0.01, ref_step_size=0.002, min_gradient=0.01)


def t(a, dtype=torch.float32):
    return interop.tensor(a, dtype=dtype)


def scene(translation, rotvec=(0.0, 0.0, 0.0)):
    """tests/vo/test_sweep_rect.py's two-view scene: (key Frame, JAX
    keyframe, JAX stacked refframe)."""
    poses = [JPose.identity(),
             JPose.from_rotvec(jnp.asarray(rotvec, jnp.float32),
                               jnp.asarray(translation, jnp.float32))]
    ds = PlaneSceneDataset(n_frames=2, image_shape=(H, W),
                           focal_length=FOCAL, poses=poses,
                           plane_origin=(0.0, 0.0, 10.0),
                           plane_normal=(0.05, -0.02, -1.0))
    key, ref = ds[0], ds[1]
    cam = JCameraParameters.create(FOCAL, (W / 2, H / 2))
    return (key, jmake_frame(cam, key.image, key.pose.T),
            jstack([jmake_frame(cam, ref.image, ref.pose.T)]))


def relative(kf, refs):
    return np.asarray(jinv(refs.transform_wf[0]) @ kf.transform_wf)


# --------------------------------------------------------------- geometry

def test_inv3_cross3_norm3():
    """On seeded well-conditioned 3x3 matrices: inv3 within 1e-6 of the
    float64 inverse (relative to its largest entry), cross3 and norm3
    within 1e-6 of numpy's float64 results."""
    gen = np.random.default_rng(0)
    A = (np.eye(3) * 3.0 + gen.uniform(-1, 1, (16, 3, 3))).astype(np.float32)
    ref = np.linalg.inv(A.astype(np.float64))
    port = inv3(t(A)).numpy()
    scale = np.abs(ref).max(axis=(1, 2), keepdims=True)
    assert np.all(np.abs(port - ref) <= 1e-6 * scale)
    a, b = A[:, 0], A[:, 1]
    np.testing.assert_allclose(cross3(t(a), t(b)).numpy(),
                               np.cross(a.astype(np.float64), b), atol=1e-6)
    np.testing.assert_allclose(norm3(t(a)).numpy(),
                               np.linalg.norm(a.astype(np.float64), axis=1),
                               rtol=1e-6)


@pytest.mark.parametrize("flip", [False, True])
def test_make_rectification(flip):
    """Every field within 1e-6 of JAX's, relative to the field's largest
    entry (the inverses are an adjugate here, an LU solve there), on a
    pair with a rotation and a baseline off the x-axis."""
    sign = -1.0 if flip else 1.0
    _, kf, refs = scene((sign * 0.4, 0.1, 0.05), rotvec=(0.01, -0.02, 0.005))
    T_rk = relative(kf, refs)
    assert baseline_flip(T_rk) == flip
    ref = jmake_rectification(jnp.asarray(T_rk), kf.focal_length, kf.offset,
                              refs.focal_length[0], refs.offset[0], flip)
    port = make_rectification(t(T_rk), t(kf.focal_length), t(kf.offset),
                              t(refs.focal_length[0]), t(refs.offset[0]),
                              flip)
    for name, p, r in zip(port._fields, port, ref):
        p, r = p.numpy(), np.asarray(r)
        assert np.abs(p - r).max() <= 1e-6 * np.abs(r).max(), name


# ------------------------------------------------------------------ warps

@pytest.mark.parametrize("shift", [-7.25, -3.0, 0.0, 0.5, 12.75, 200.0])
def test_const_shift_cols(shift):
    """Equal to the JAX function within 1e-6 (the same lerp, rounded the
    same or contracted by XLA), fill lanes included, on (H, W) and
    (C, H, W) images."""
    gen = np.random.default_rng(1)
    img = gen.random((3, 16, 40)).astype(np.float32)
    for x in (img, img[0]):
        port = const_shift_cols(t(x), torch.tensor(shift)).numpy()
        ref = np.asarray(jconst_shift_cols(jnp.asarray(x),
                                           jnp.float32(shift)))
        np.testing.assert_allclose(port, ref, rtol=0, atol=1e-6)


def test_homography_warp_channels():
    """A (C, H, W) warp equals the warps of its channels, bit for bit."""
    gen = np.random.default_rng(2)
    img = t(gen.random((3, 32, 48)))
    H33 = t([[1.01, 0.02, -1.5], [-0.01, 0.99, 2.0], [1e-4, -2e-4, 1.0]])
    out, valid = homography_warp(img, H33)
    for c in range(3):
        out_c, valid_c = homography_warp(img[c], H33)
        assert torch.equal(out[c], out_c) and torch.equal(valid, valid_c)


def test_rot_warp_matches_where_both_valid():
    """The port's gather warp against the JAX tent warp (budget 32) on a
    rectification homography: values within 1e-4 where both are valid
    (tests/core/test_shiftwarp.py's bound), and validity differing on at
    most 2% of the lanes (the JAX budget and its clamped edge lanes)."""
    _, kf, refs = scene((0.4, 0.1, 0.05), rotvec=(0.01, -0.02, 0.005))
    T_rk = relative(kf, refs)
    rect = jmake_rectification(jnp.asarray(T_rk), kf.focal_length,
                               kf.offset, refs.focal_length[0],
                               refs.offset[0], baseline_flip(T_rk))
    image = np.asarray(refs.image[0])
    for H33 in (rect.H_ref_inv, rect.H_key):
        ref, jvalid = (np.asarray(x) for x in jrot_warp(
            jnp.asarray(image), H33, 32, 32, fill=-1.0))
        port, valid = (x.numpy() for x in rot_warp(t(image), t(H33)))
        both = valid & jvalid
        assert both.mean() > 0.6
        np.testing.assert_allclose(port[both], ref[both], atol=1e-4)
        assert np.mean(valid != jvalid) <= 0.02


def test_shift_stack_and_key_template():
    """Bit-equal to the JAX functions."""
    gen = np.random.default_rng(3)
    base = gen.random((8, 24)).astype(np.float32)
    np.testing.assert_array_equal(
        _shift_stack(t(base), 10, fill=-1.0).numpy(),
        np.asarray(j_shift_stack(jnp.asarray(base), 10, -1.0)))
    np.testing.assert_array_equal(
        _key_template(t(base)).numpy(),
        np.asarray(j_key_template(jnp.asarray(base))))


# ----------------------------------------------------------- full update

@pytest.mark.parametrize("flip", [False, True])
def test_update_depth_rect(flip):
    """tests/vo/test_sweep_rect.py's lateral scene (0.5 m, leftward with
    ``flip``), 64 planes, prior within 2 m of the truth: flags agree on
    >= 98% of pixels and, on pixels SUCCESS on both, the relative depth
    difference has median <= 1e-3.  (Measured: 98.46%, the rest on row 0,
    where JAX's LU inverse puts the source row a hair above the image;
    median 3e-6.)  The JAX update runs with the dispatcher's budget 32."""
    key, kf, refs = scene((-0.5 if flip else 0.5, 0.0, 0.0))
    assert baseline_flip(relative(kf, refs)) == flip
    gt = np.asarray(key.depth_map)
    gen = np.random.default_rng(7)
    prior = (gt + gen.uniform(-2, 2, gt.shape)).astype(np.float32)
    prior_var = np.full_like(prior, 0.05)
    age = np.ones((H, W), np.int32)
    jparams = JParams.create(**PARAMS_ARGS)
    jdepth, _, jflags = (np.asarray(x) for x in jupdate_depth_rect(
        kf, refs, jnp.asarray(age), jnp.asarray(prior),
        jnp.asarray(prior_var), jparams, n_planes=64, flips=(flip,),
        max_dx=32, max_dy=32, use_pallas=False))
    depth, variance, flags = interop.to_numpy(update_depth_rect(
        interop.frame_from_numpy(*kf), interop.frame_from_numpy(*refs),
        t(age, torch.int32), t(prior), t(prior_var),
        interop.params_from_numpy(jparams), n_planes=64, flips=(flip,)))
    assert np.mean(flags == jflags) >= 0.98
    both = (flags == 0) & (jflags == 0)
    assert both.mean() > 0.3
    rel = np.abs(depth - jdepth)[both] / jdepth[both]
    assert np.median(rel) <= 1e-3, np.median(rel)
    success = flags == int(Flag.SUCCESS)
    assert np.median(np.abs(depth - gt)[success]) < 0.5
    assert np.all(np.isfinite(variance)) and np.all(variance > 0)


@pytest.mark.parametrize("out_rows", [(0, 12), (17, 9), (40, 8)])
def test_rot_warp_out_rows(out_rows):
    """``out_rows = (y0, n)`` gives rows y0 .. y0+n-1 of the whole warp
    bit for bit, and matches the JAX row-block warp (budget 32) where
    both are valid, as the whole warp does."""
    _, kf, refs = scene((0.4, 0.1, 0.05), rotvec=(0.01, -0.02, 0.005))
    T_rk = relative(kf, refs)
    rect = jmake_rectification(jnp.asarray(T_rk), kf.focal_length,
                               kf.offset, refs.focal_length[0],
                               refs.offset[0], baseline_flip(T_rk))
    image = np.asarray(refs.image[0])
    y0, n = out_rows
    whole, whole_valid = rot_warp(t(image), t(rect.H_ref_inv))
    block, valid = rot_warp(t(image), t(rect.H_ref_inv), out_rows=out_rows)
    assert torch.equal(block, whole[y0:y0 + n])
    assert torch.equal(valid, whole_valid[y0:y0 + n])
    ref, jvalid = (np.asarray(x) for x in jrot_warp(
        jnp.asarray(image), rect.H_ref_inv, 32, 32, fill=-1.0,
        out_rows=out_rows))
    both = valid.numpy() & jvalid
    np.testing.assert_allclose(block.numpy()[both], ref[both], atol=1e-4)
    assert np.mean(valid.numpy() != jvalid) <= 0.02
