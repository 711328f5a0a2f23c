"""Parity of the port's plane sweep, SSD search and planner with the JAX
package, on the CPU.  (The SSD kernel's own test is in
test_torch_kernels.py, which imports no JAX, so that it runs on a card.)

Inputs come from seeded numpy generators and the JAX package's
synthetic renderer.  The JAX sweep runs in its gather form
(warp_budget=0, key_budget=0) with the XLA SSD search, as the JAX
package's own tests run it on the CPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tadataka_tpu.camera import CameraParameters as JCameraParameters
from tadataka_tpu.core.pose import Pose as JPose
from tadataka_tpu.core.transforms import inv_motion_matrix as jinv
from tadataka_tpu.dataset import PlaneSceneDataset
from tadataka_tpu.vo.semi_dense import SemiDenseParams as JParams
from tadataka_tpu.vo.semi_dense import make_frame as jmake_frame
from tadataka_tpu.vo.semi_dense.estimator import (
    pixel_geometry_map as jpixel_geometry_map,
    calc_key_epipole as jcalc_key_epipole)
from tadataka_tpu.vo.semi_dense.fast import plan_update_np as jplan
from tadataka_tpu.vo.semi_dense.fast import UpdatePlan as JUpdatePlan
from tadataka_tpu.vo.semi_dense.fast import (
    update_depth_fast as jupdate_depth_fast)
from tadataka_tpu.vo.semi_dense.frame import stack_frames as jstack
from tadataka_tpu.vo.semi_dense.sweep import (
    _ssd_search_xla, update_depth_sweep as jupdate_depth_sweep)

from tadataka_torch import interop
from tadataka_torch.flags import Flag
from tadataka_torch.core.transforms import inv_motion_matrix
from tadataka_torch.vo.semi_dense.estimator import (
    pixel_geometry_map, calc_key_epipole)
from tadataka_torch.vo.semi_dense.fast import (
    plan_update_np, update_depth_fast, UpdatePlan)
from tadataka_torch.vo.semi_dense.rectify import baseline_flip
from tadataka_torch.vo.semi_dense.sweep import (
    ssd_search, update_depth_sweep, _INF)

from tests.test_torch_kernels import SSD_CASES, ssd_case


def t(a, dtype=torch.float32):
    return interop.tensor(a, dtype=dtype)


# ------------------------------------------------------------- SSD search

@pytest.mark.parametrize("S", [16, 32])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_search_plain_matches_xla(case, S):
    """best equal everywhere; the three errors within 1e-6 (float32,
    the norm of K summed in possibly another order)."""
    V, K, mlo, mhi = ssd_case(case, S)
    best, ec, ep, en = ssd_search(t(V), t(K), t(mlo), t(mhi))
    jbest, jec, jep, jen = (np.asarray(x) for x in _ssd_search_xla(
        jnp.asarray(V), jnp.asarray(K), jnp.asarray(mlo), jnp.asarray(mhi)))
    np.testing.assert_array_equal(best.numpy(), jbest)
    for port, ref in ((ec, jec), (ep, jep), (en, jen)):
        np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=1e-6)
    if case == "planted":
        assert np.all(jbest == 6)
    if case == "ties":
        assert np.all(best.numpy()[:, 8:] == 6)
        assert np.all(best.numpy()[:, :8] == 0)
    if case == "all_invalid":
        assert np.all(best.numpy()[:6] == -1)
        assert np.all(ec.numpy()[:6] >= _INF)


# ------------------------------------------------------ sweep and geometry

H, W = 64, 128
FOCAL = (60.0, 60.0)
PARAMS_ARGS = dict(min_depth=2.0, max_depth=50.0, geo_coeff=0.01,
                   photo_coeff=0.01, ref_step_size=0.002, min_gradient=0.01)


@pytest.fixture(scope="module")
def history_scene():
    """A keyframe and a 3-refframe history on a lateral+forward track."""
    poses = [JPose.from_rotvec(jnp.float32([0.0, 0.004 * i, 0.0]),
                               jnp.float32([0.12 * i, 0.01 * i, 0.03 * i]))
             for i in range(4)]
    ds = PlaneSceneDataset(n_frames=4, image_shape=(H, W),
                           focal_length=FOCAL, poses=poses,
                           plane_origin=(0.0, 0.0, 10.0),
                           plane_normal=(0.05, -0.02, -1.0))
    frames = [ds[i] for i in range(4)]
    jcam = JCameraParameters.create(FOCAL, (W / 2, H / 2))
    key = jmake_frame(jcam, frames[3].image, frames[3].pose.T)
    refs = jstack([jmake_frame(jcam, f.image, f.pose.T)
                   for f in frames[:3]])
    gen = np.random.default_rng(5)
    gt = np.asarray(frames[3].depth_map)
    prior_depth = (gt * gen.uniform(0.9, 1.1, gt.shape)).astype(np.float32)
    prior_var = gen.uniform(0.002, 0.02, gt.shape).astype(np.float32)
    age = gen.integers(0, 4, gt.shape).astype(np.int32)
    return key, refs, prior_depth, prior_var, age, gt


def port_frames(key, refs):
    return (interop.frame_from_numpy(*key), interop.frame_from_numpy(*refs))


def test_pixel_geometry_map(history_scene):
    key, refs, prior_depth, prior_var, _, _ = history_scene
    jparams = JParams.create(**PARAMS_ARGS)
    params = interop.params_from_numpy(jparams)
    us_x = np.tile(np.arange(W, dtype=np.float32), H)
    us_y = np.repeat(np.arange(H, dtype=np.float32), W)
    p_inv = (1.0 / (prior_depth.ravel() + 1e-16)).astype(np.float32)
    p_var = prior_var.ravel()
    T_rk = np.asarray(jinv(refs.transform_wf[1]) @ key.transform_wf)
    e_key = np.asarray(jcalc_key_epipole(key.transform_wf,
                                         refs.transform_wf[1]))
    np.testing.assert_allclose(
        calc_key_epipole(t(key.transform_wf),
                         t(refs.transform_wf[1])).numpy(),
        e_key, rtol=1e-5, atol=1e-6)
    args = (t(us_x), t(us_y), t(p_inv), t(p_var), t(T_rk), t(e_key),
            t(key.focal_length), t(key.offset), (H, W),
            t(refs.focal_length[1]), t(refs.offset[1]), (H, W), params, 48)
    port = pixel_geometry_map(*args)
    ref = jpixel_geometry_map(us_x, us_y, p_inv, p_var, T_rk, e_key,
                              key.focal_length, key.offset, (H, W),
                              refs.focal_length[1], refs.offset[1], (H, W),
                              jparams, 48)
    for name, p, r in zip(port._fields, port, ref):
        p, r = p.numpy(), np.asarray(r)
        if p.dtype == bool or name == "n_samples":
            # integer/boolean fields: equal but for lanes sitting on a
            # float threshold (at most 0.1% of the map)
            assert np.mean(p != r) <= 1e-3, name
        else:
            np.testing.assert_allclose(p, r, rtol=2e-5, atol=1e-6,
                                       err_msg=name)


N_PLANES = (48, 32, 32)
REDIRECT = (1, 1, 2)        # refframe 0's pixels search refframe 1


@pytest.fixture(scope="module")
def sweep_pair(history_scene):
    key, refs, prior_depth, prior_var, age, gt = history_scene
    jparams = JParams.create(**PARAMS_ARGS)
    ref = tuple(np.asarray(x) for x in jupdate_depth_sweep(
        key, refs, jnp.asarray(age), jnp.asarray(prior_depth),
        jnp.asarray(prior_var), jparams, n_planes=N_PLANES,
        use_pallas=False, warp_budget=0, key_budget=0, redirect=REDIRECT,
        fuse_prior=True))
    pkey, prefs = port_frames(key, refs)
    port = interop.to_numpy(update_depth_sweep(
        pkey, prefs, t(age, torch.int32), t(prior_depth), t(prior_var),
        interop.params_from_numpy(jparams), n_planes=N_PLANES,
        redirect=REDIRECT, fuse_prior=True))
    return port, ref, gt


def test_update_depth_sweep_flags(sweep_pair):
    """Flag maps agree on >= 99.5% of pixels (a flag flips only where a
    float comparison sits on its threshold), and the sweep succeeds on a
    real share of the pixels (a quarter of them have age 0)."""
    (_, _, flags), (_, _, jflags), _ = sweep_pair
    assert np.mean(flags == jflags) >= 0.995
    assert np.mean(flags == int(Flag.SUCCESS)) > 0.1


def test_update_depth_sweep_depth_and_variance(sweep_pair):
    """On pixels SUCCESS on both sides.  The warped samples differ by an
    ulp (XLA contracts the lerps into fused multiply-adds; PyTorch's CPU
    kernels round every operation), and the window argmin and the
    parabola amplify that where the error curve is flat: one plane step
    is ~18% of q here.  So the bounds are on quantiles of the relative
    difference: depth median <= 5e-5, 90th <= 1e-3, 99th <= 1e-2;
    variance median <= 1e-5, 99th <= 1e-3."""
    (depth, var, flags), (jdepth, jvar, jflags), gt = sweep_pair
    both = (flags == 0) & (jflags == 0)

    def rel_quantiles(port, ref):
        rel = np.abs(port - ref)[both] / np.abs(ref)[both]
        return np.quantile(rel, [0.5, 0.9, 0.99])

    q50, q90, q99 = rel_quantiles(depth, jdepth)
    assert q50 <= 5e-5 and q90 <= 1e-3 and q99 <= 1e-2, (q50, q90, q99)
    q50, _, q99 = rel_quantiles(var, jvar)
    assert q50 <= 1e-5 and q99 <= 1e-3, (q50, q99)
    # and the update is a depth estimate, not noise
    assert np.median(np.abs(depth - gt)[both] / gt[both]) < 0.05


# ----------------------------------------------------------------- planner

def vga_trajectory(n=12):
    """Camera->world 4x4 poses of the 480x640 trajectory the app test on
    the card runs: rotvec (0, 0.002 i, 0), t (0.02 i, 0.002 i, 0.01 i)."""
    return [np.asarray(JPose.from_rotvec(
        jnp.float32([0.0, 0.002 * i, 0.0]),
        jnp.float32([0.02 * i, 0.002 * i, 0.01 * i])).T, np.float64)
        for i in range(n)]


def planner_args(key_T, ref_Ts, shape=(480, 640), focal=480.0):
    f = np.array([focal, focal])
    c = np.array([shape[1] / 2.0, shape[0] / 2.0])
    n = len(ref_Ts)
    return (key_T, f, c, shape, np.stack(ref_Ts),
            np.broadcast_to(f, (n, 2)), np.broadcast_to(c, (n, 2)),
            1.0 / 50.0, 1.0 / 2.0)


def test_planner_matches_on_vga_trajectory():
    """Equal plans on every frame of the 480x640 trajectory (history 8),
    and every one of them is the homography sweep."""
    Ts = vga_trajectory()
    for k in range(1, len(Ts)):
        args = planner_args(Ts[k], Ts[max(0, k - 8):k])
        plan = plan_update_np(*args)
        assert tuple(plan) == tuple(jplan(*args)), k
        assert plan.path == "tent", (k, plan)


def test_planner_matches_on_lateral_trajectory():
    """The 480x640 lateral trajectory of chip_smoke.py's rect phase
    (rotvec (0, 0.002 i, 0), t (0.1, 0.005, 0) i, history 8): equal
    plans on every frame, the rectified sweep from frame 2 on, with
    stacks of 64 to 208 planes."""
    Ts = [np.asarray(JPose.from_rotvec(
        jnp.float32([0.0, 0.002 * i, 0.0]),
        jnp.float32([0.1 * i, 0.005 * i, 0.0])).T, np.float64)
        for i in range(10)]
    paths = []
    for k in range(1, len(Ts)):
        args = planner_args(Ts[k], Ts[max(0, k - 8):k])
        plan = plan_update_np(*args)
        assert tuple(plan) == tuple(jplan(*args)), k
        paths.append(plan.path)
        if plan.path == "rect":
            assert 64 <= plan.n_planes[0] <= 208, plan
    assert paths == ["tent"] + ["rect"] * 8, paths


def test_planner_matches_on_stereo_pair():
    """A 0.5 m lateral stereo pair: too wide for the sweep's displacement
    cap, so both planners choose the rectified sweep."""
    key_T = np.eye(4)
    ref_T = np.eye(4)
    ref_T[0, 3] = 0.5
    args = planner_args(key_T, [ref_T])
    plan = plan_update_np(*args)
    assert tuple(plan) == tuple(jplan(*args))
    assert plan.path == "rect"


@pytest.mark.parametrize("path", ["rect", "scatter"])
def test_update_depth_fast_refuses_unported_paths(history_scene, path):
    """``update_depth_fast`` on a forced 'rect' or 'scatter' plan (the
    history scene plans 'tent') against the JAX dispatcher on the same
    plan, each refframe's flip from ``baseline_flip``.  Both paths are
    ported and refuse nothing; the port's warps have no displacement
    budget, where the JAX rectification warps mark lanes over 32 px
    invalid.  Flags agree on >= 98% (rect) / 99.5% (scatter) of pixels;
    on pixels SUCCESS on both the relative depth difference has median
    <= 1e-3 (rect) / 5e-5 (scatter).  (Measured: flags equal, medians
    9e-8 and 5e-7.)  The name dates from when these paths raised; it
    is kept so the test's history stays one line."""
    key, refs, prior_depth, prior_var, age, _ = history_scene
    pkey, prefs = port_frames(key, refs)
    flips = tuple(baseline_flip(np.asarray(
        jinv(refs.transform_wf[r]) @ key.transform_wf)) for r in range(3))
    plan = UpdatePlan(path, (64,) if path == "rect" else (),
                      flips if path == "rect" else (), (), ())
    jparams = JParams.create(**PARAMS_ARGS)
    depth, _, flags = interop.to_numpy(update_depth_fast(
        pkey, prefs, t(age, torch.int32), t(prior_depth), t(prior_var),
        interop.params_from_numpy(jparams), plan=plan, fuse_prior=True))
    jdepth, _, jflags = (np.asarray(x) for x in jupdate_depth_fast(
        key, refs, jnp.asarray(age), jnp.asarray(prior_depth),
        jnp.asarray(prior_var), jparams, use_pallas=False,
        plan=JUpdatePlan(*plan), fuse_prior=True))
    agree, median = (0.98, 1e-3) if path == "rect" else (0.995, 5e-5)
    assert np.mean(flags == jflags) >= agree, np.mean(flags == jflags)
    both = (flags == 0) & (jflags == 0)
    assert both.mean() > 0.05
    rel = np.abs(depth - jdepth)[both] / jdepth[both]
    assert np.median(rel) <= median, np.median(rel)
