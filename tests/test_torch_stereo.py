"""Parity of the port's rectified-stereo matcher (``vo/stereo.py``) with
the JAX package's, on the CPU, on a small rendered pair: three planes
(the multi-plane scene) seen by a 64x128 rectified pair 2 m apart at
focal 64, so their disparities lie at 13.8-25.9 px, matched at
``max_disparity=32``.

The JAX box filter is a difference of cumulative sums and the port's a
fixed-order sum of the taps, so costs differ in the last bits; where a
cost curve is flat that can move an argmin, hence the shares below.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tadataka_tpu.camera import CameraModel as JCameraModel
from tadataka_tpu.camera import CameraParameters as JCameraParameters
from tadataka_tpu.core.pose import Pose as JPose
from tadataka_tpu.dataset.synthetic import render_plane_scene as jrender
from tadataka_tpu.vo import stereo as jstereo

from tadataka_torch.camera import CameraParameters
from tadataka_torch.dataset.synthetic import MULTI_PLANES
from tadataka_torch.vo import stereo

H, W = 64, 128
FOCAL = 64.0
BASELINE = 2.0
MAX_DISPARITY = 32


@pytest.fixture(scope="module")
def pair():
    """(left, right, left depth) rendered by the JAX package."""
    jcam = JCameraModel.create(JCameraParameters.create((FOCAL, FOCAL),
                                                        (W / 2, H / 2)))
    left, depth = jrender(jcam, JPose.identity(), (H, W),
                          planes=MULTI_PLANES)
    right, _ = jrender(jcam,
                       JPose(jnp.eye(3), jnp.float32([BASELINE, 0, 0])),
                       (H, W), planes=MULTI_PLANES)
    return tuple(np.array(x) for x in (left, right, depth))


@pytest.fixture(scope="module")
def matched(pair):
    left, right, _ = pair
    jd, jv = jstereo.match_stereo(jnp.asarray(left), jnp.asarray(right),
                                  max_disparity=MAX_DISPARITY, radius=3)
    pd, pv = stereo.match_stereo(torch.from_numpy(left),
                                 torch.from_numpy(right),
                                 max_disparity=MAX_DISPARITY, radius=3)
    return np.asarray(jd), np.asarray(jv), pd.numpy(), pv.numpy()


@pytest.mark.parametrize("radius", [1, 3])
def test_box_filter(radius):
    """On seeded uniform [0, 1) stacks: the port's fixed-order sum within
    rtol 1e-6 of the exact (float64) moving sum, which its 2r adds of
    non-negative terms bound by 2r ulp, and within rtol 1e-5 of the JAX
    filter, whose differences of prefix sums are themselves off the
    exact sum by more than 1e-6 (at r = 3: the port 1.6e-7, JAX 1.2e-6,
    read by tools/stereo_vs_jax.py)."""
    x = np.random.default_rng(5).random((3, 24, 40), dtype=np.float32)
    port = stereo._box_filter(torch.from_numpy(x), radius).numpy()
    exact = stereo._box_filter(torch.from_numpy(x.astype(np.float64)),
                               radius).numpy()
    jax_sum = np.asarray(jstereo._box_filter(jnp.asarray(x), radius))
    np.testing.assert_allclose(port, exact, rtol=1e-6)
    np.testing.assert_allclose(port, jax_sum, rtol=1e-5)


def test_box_filter_is_the_zero_padded_moving_sum():
    """Small integers sum exactly: the filter equals the moving sum over
    the zero-padded image, computed here by an explicit double loop."""
    x = np.random.default_rng(6).integers(0, 9, (7, 9)).astype(np.float32)
    r = 2
    padded = np.pad(x, r)
    want = np.array([[padded[i:i + 2 * r + 1, j:j + 2 * r + 1].sum()
                      for j in range(9)] for i in range(7)])
    np.testing.assert_array_equal(
        stereo._box_filter(torch.from_numpy(x), r).numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(jstereo._box_filter(jnp.asarray(x), r)), want)


def test_valid_masks_agree(matched):
    """The valid masks agree on >= 99% of pixels (all, measured), and
    most of the columns past max_disparity are valid."""
    jd, jv, pd, pv = matched
    assert np.mean(jv == pv) >= 0.99, np.mean(jv == pv)
    assert pv.mean() > 0.5, pv.mean()


def test_disparities_agree(matched):
    """On pixels valid on both sides the integer disparity (the sub-pixel
    disparity rounded: the parabola's vertex stays within half a pixel of
    a valid winner) is equal on >= 99% of them (all, measured), and where
    it is equal the sub-pixel disparities differ by <= 1e-3 px (4.4e-5
    measured)."""
    jd, jv, pd, pv = matched
    both = jv & pv
    same = np.rint(jd) == np.rint(pd)
    assert same[both].mean() >= 0.99, same[both].mean()
    assert np.abs(jd - pd)[both & same].max() <= 1e-3


def test_depth_matches(pair):
    """``estimate_depth_from_stereo`` on both sides: relative depth
    difference <= 1e-4 where both are valid, and the port's median
    |depth - GT| on its valid pixels < 0.05 m (planes at 5.6-9.3 m)."""
    left, right, gt = pair
    jcam = JCameraParameters.create((FOCAL, FOCAL), (W / 2, H / 2))
    jdepth, jvalid = (np.asarray(x)
                      for x in jstereo.estimate_depth_from_stereo(
                          jcam, left, right, BASELINE,
                          max_disparity=MAX_DISPARITY))
    depth, valid = stereo.estimate_depth_from_stereo(
        CameraParameters.create((FOCAL, FOCAL), (W / 2, H / 2)), left, right,
        BASELINE, max_disparity=MAX_DISPARITY, device="cpu")
    depth, valid = depth.numpy(), valid.numpy()
    assert depth.dtype == np.float32 and valid.dtype == bool
    both = jvalid & valid
    np.testing.assert_allclose(depth[both], jdepth[both], rtol=1e-4)
    assert np.median(np.abs(depth - gt)[valid]) < 0.05


def test_argmin_takes_the_first_of_equal_costs():
    """``torch.argmin`` and ``jnp.argmin`` both take the first index of
    equal minima, so a tie in the cost volume resolves alike."""
    costs = np.full((9, 4, 5), 3.0, np.float32)
    costs[2] = costs[6] = 1.0          # two equal minima
    costs[:, 0, 0] = 0.5               # every disparity ties
    port = torch.argmin(torch.from_numpy(costs), dim=0).numpy()
    ref = np.asarray(jnp.argmin(jnp.asarray(costs), axis=0))
    np.testing.assert_array_equal(port, ref)
    assert port[0, 0] == 0 and np.all(port.ravel()[1:] == 2)


def test_flat_pair_ties_every_disparity():
    """On a constant pair every unpenalized disparity costs 0: both
    matchers take disparity 0 (the first), and the texture gate leaves
    no pixel valid."""
    flat = np.full((16, 48), 0.5, np.float32)
    jd, jv = jstereo.match_stereo(jnp.asarray(flat), jnp.asarray(flat),
                                  max_disparity=8, radius=2)
    pd, pv = stereo.match_stereo(torch.from_numpy(flat),
                                 torch.from_numpy(flat), max_disparity=8,
                                 radius=2)
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    assert not pv.any()


def test_entry_point_runs_on_the_card_unless_asked(monkeypatch, pair):
    """``estimate_depth_from_stereo`` defaults to the card: without one it
    raises instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    left, right, _ = pair
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stereo.estimate_depth_from_stereo(
            CameraParameters.create((FOCAL, FOCAL), (W / 2, H / 2)), left,
            right, BASELINE)
