"""Parity of the port's bundle adjustment (``ba/{residuals,schur,api}.py``)
with the JAX package's, on the CPU, on seeded scenes: 4-5 viewpoints
within 0.5 m and 0.1 rad of the origin, 40-60 points 4-6 m ahead, each
point seen by a seeded subset of at least two viewpoints (so that the
padded JAX run and the unpadded port run see the same problem), the
poses and points perturbed before the solve.

Tolerances: projections and Jacobians within 1e-5 (JAX's jacfwd and
torch.func.jacfwd differentiate the same formula; also at rotvec 0,
where exp_so3's small-angle branch must stay finite); the assembled
normal equations within 1e-5 of their scale; a Schur step within 1e-4.
LM results are held where the problem fixes them: no pose is held fixed,
so a solve has a 7-dof gauge (rotation, translation, scale) along which
damped steps drift with rounding once the error is near 0.  Each
observation's projection (gauge-free) within 1e-5, the final error
within 1e-9 or 1e-2 relative, poses within 5e-3 and points within
1e-2 m.  The JAX run_ba pads
observations, points and poses to powers of two with zero-weight rows;
the port runs at the true counts.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose
from scipy.spatial.transform import Rotation

from tadataka_tpu.ba import api as japi
from tadataka_tpu.ba import residuals as jres
from tadataka_tpu.ba import schur as jschur
from tadataka_tpu.core.pose import Pose as JPose

from tadataka_torch.ba import api, residuals, schur
from tadataka_torch.interop import poses_from_numpy


def T(a, dtype=None):
    return torch.tensor(np.array(a), dtype=dtype)


def close(a, b, atol, rtol=0.0):
    assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def make_problem(seed, n_views=4, n_points=50, noise=0.01):
    """(true poses (M, 6), true points, noisy poses, noisy points, vi, pi,
    x_true): each point seen by a random subset of >= 2 viewpoints."""
    rng = np.random.default_rng(seed)
    points = rng.uniform(-1, 1, (n_points, 3)).astype(np.float32)
    points[:, 2] += 5.0
    poses = np.hstack([rng.uniform(-0.1, 0.1, (n_views, 3)),
                       rng.uniform(-0.5, 0.5, (n_views, 3))]).astype(
                           np.float32)
    seen = rng.random((n_views, n_points)) < 0.7
    seen[rng.integers(0, n_views, n_points), np.arange(n_points)] = True
    seen[(np.arange(n_points) + 1) % n_views, np.arange(n_points)] = True
    seen[0, :] |= ~seen[1:].any(0)
    vi, pi_ = np.nonzero(seen)
    x_true = np.asarray(jax.vmap(jres.transform_project)(
        jnp.asarray(poses[vi]), jnp.asarray(points[pi_])))
    noisy_poses = poses + rng.normal(0, noise, poses.shape).astype(
        np.float32)
    noisy_poses[0] = poses[0]
    noisy_points = points + rng.normal(0, 5 * noise, points.shape).astype(
        np.float32)
    return (poses, points, noisy_poses, noisy_points, vi.astype(np.int64),
            pi_.astype(np.int64), x_true.astype(np.float32))


@pytest.mark.parametrize("rotvec", ["zero", "random"])
def test_transform_project_and_jacobians(rotvec):
    rng = np.random.default_rng(0)
    poses = rng.uniform(-0.5, 0.5, (16, 6)).astype(np.float32)
    if rotvec == "zero":
        poses[:, :3] = 0.0
    points = rng.uniform(-1, 1, (16, 3)).astype(np.float32)
    points[:, 2] += 4.0
    jp, jx = jnp.asarray(poses), jnp.asarray(points)
    close(residuals.transform_project(T(poses), T(points)),
          jax.vmap(jres.transform_project)(jp, jx), 1e-6)
    A_ref = jax.vmap(jres.pose_jacobian)(jp, jx)
    B_ref = jax.vmap(jres.point_jacobian)(jp, jx)
    A = torch.func.vmap(residuals.pose_jacobian)(T(poses), T(points))
    B = torch.func.vmap(residuals.point_jacobian)(T(poses), T(points))
    assert torch.isfinite(A).all() and torch.isfinite(B).all()
    close(A, A_ref, 1e-5)
    close(B, B_ref, 1e-5)
    # one observation, unbatched, as jax.jacfwd takes it
    close(residuals.pose_jacobian(T(poses[3]), T(points[3])),
          jres.pose_jacobian(jp[3], jx[3]), 1e-5)
    close(residuals.point_jacobian(T(poses[3]), T(points[3])),
          jres.point_jacobian(jp[3], jx[3]), 1e-5)


def test_residuals_and_assemble():
    _, _, po, pt, vi, pi_, x = make_problem(1)
    w = (np.arange(len(vi)) % 7 != 0).astype(np.float32)
    r_ref = jres.projection_residuals(jnp.asarray(po), jnp.asarray(pt),
                                      jnp.asarray(vi), jnp.asarray(pi_),
                                      jnp.asarray(x))
    r = residuals.projection_residuals(T(po), T(pt), T(vi), T(pi_), T(x))
    close(r, r_ref, 1e-6)
    ref = jschur._assemble(jnp.asarray(po), jnp.asarray(pt),
                           jnp.asarray(vi), jnp.asarray(pi_),
                           jnp.asarray(x), jnp.asarray(w))
    out = schur._assemble(T(po), T(pt), T(vi), T(pi_), T(x), T(w))
    for a, b in zip(out, ref):
        b = np.asarray(b)
        close(a, b, 1e-5 * max(np.abs(b).max(), 1e-3))


def test_assemble_card_layout():
    """The card's sums (``_layout``: each row's terms gathered in
    observation order and summed pairwise), run here on CPU tensors:
    within the same tolerance of the JAX package's scatter-adds, and
    rows with no term exactly zero."""
    _, _, po, pt, vi, pi_, x = make_problem(1)
    w = (np.arange(len(vi)) % 7 != 0).astype(np.float32)
    ref = jschur._assemble(jnp.asarray(po), jnp.asarray(pt),
                           jnp.asarray(vi), jnp.asarray(pi_),
                           jnp.asarray(x), jnp.asarray(w))
    layout = schur._layout(T(vi), T(pi_), len(po), len(pt) + 2)
    out = schur._assemble(T(po), T(np.vstack([pt, pt[:2]])), T(vi), T(pi_),
                          T(x), T(w), layout)
    assert not out[1][-2:].any() and not out[2][-2:].any()
    assert not out[4][-2:].any()
    out = (out[0], out[1][:-2], out[2][:-2], out[3], out[4][:-2], out[5])
    for a, b in zip(out, ref):
        b = np.asarray(b)
        close(a, b, 1e-5 * max(np.abs(b).max(), 1e-3))


@pytest.mark.parametrize("mu", [1e-2, 1.0, 1e4])
def test_schur_step(mu):
    _, _, po, pt, vi, pi_, x = make_problem(2)
    w = np.ones(len(vi), np.float32)
    ref = jschur._assemble(jnp.asarray(po), jnp.asarray(pt),
                           jnp.asarray(vi), jnp.asarray(pi_),
                           jnp.asarray(x), jnp.asarray(w))
    # the same normal equations into both steps
    dpo_ref, dpt_ref = jschur._schur_step(*ref[:5], mu)
    dpo, dpt = schur._schur_step(*(T(a) for a in ref[:5]), mu)
    scale = max(np.abs(np.asarray(dpo_ref)).max(), 1e-6)
    close(dpo, dpo_ref, 1e-4 * scale)
    close(dpt, dpt_ref, 1e-4 * max(np.abs(np.asarray(dpt_ref)).max(), 1e-6))


@pytest.mark.parametrize("seed,max_iter,rel", [(3, 8, 1e-6), (4, 5, 0.2)])
def test_lm_solve(seed, max_iter, rel):
    true_poses, true_points, po, pt, vi, pi_, x = make_problem(seed)
    args = (jnp.asarray(vi), jnp.asarray(pi_), jnp.asarray(x))
    p_ref, x_ref, e_ref = jschur.lm_solve(
        jnp.asarray(po), jnp.asarray(pt), *args, max_iter=max_iter,
        relative_error_threshold=rel)
    p, x_out, e = schur.lm_solve(T(po), T(pt), T(vi), T(pi_), T(x),
                                 max_iter=max_iter,
                                 relative_error_threshold=rel)
    close(projections(p, x_out, vi, pi_), projections(p_ref, x_ref, vi, pi_),
          1e-5)
    close(e, e_ref, 1e-9, 1e-2)
    close(p, p_ref, 5e-3)
    close(x_out, x_ref, 1e-2)
    e0 = float(jnp.mean(jnp.sum(jres.projection_residuals(
        jnp.asarray(po), jnp.asarray(pt), *args) ** 2, axis=-1)))
    assert float(e) < 0.01 * e0


def test_local_bundle_adjustment():
    _, _, po, pt, vi, pi_, x = make_problem(5)
    ref = jschur.LocalBundleAdjustment(vi, pi_, x).compute(
        po[:, :3], po[:, 3:], pt, max_iter=6)
    out = schur.LocalBundleAdjustment(vi, pi_, x, device="cpu").compute(
        po[:, :3], po[:, 3:], pt, max_iter=6)
    for a, b, atol in zip(out, ref, (5e-3, 5e-3, 1e-2)):
        close(a, b, atol)
    close(projections(torch.cat(out[:2], -1), out[2], vi, pi_),
          projections(np.hstack(ref[:2]), ref[2], vi, pi_), 1e-5)


def projections(pose_params, points, vi, pi_):
    """Every observation's projection (gauge-free), through the JAX
    function."""
    pose_params, points = np.asarray(pose_params), np.asarray(points)
    return np.asarray(jax.vmap(jres.transform_project)(
        jnp.asarray(pose_params[vi]), jnp.asarray(points[pi_])))


def pose_params(poses):
    return np.stack([np.r_[Rotation.from_matrix(np.asarray(p.R, np.float64))
                           .as_rotvec(), np.asarray(p.t)] for p in poses])


def jax_poses(params):
    return [JPose(jnp.asarray(Rotation.from_rotvec(p[:3]).as_matrix(),
                              jnp.float32), jnp.asarray(p[3:]))
            for p in params]


@pytest.mark.parametrize("seed,n_views,n_points", [(6, 3, 40), (7, 5, 60)])
def test_run_ba_unpadded_vs_padded(seed, n_views, n_points):
    """The port's run_ba at the true counts against the JAX package's,
    which pads observations, points and poses (3 -> 4, 5 -> 8) with
    zero-weight rows."""
    _, _, po, pt, vi, pi_, x = make_problem(seed, n_views, n_points)
    jposes = jax_poses(po)
    ref_poses, ref_points = japi.run_ba(vi, pi_, jposes, pt, x)
    poses, points = api.run_ba(vi, pi_, poses_from_numpy(jposes), pt, x,
                               device="cpu")
    assert len(poses) == n_views and points.shape == (n_points, 3)
    close(projections(pose_params(poses), points, vi, pi_),
          projections(pose_params(ref_poses), ref_points, vi, pi_), 1e-5)
    for a, b in zip(poses, ref_poses):
        close(a.R, b.R, 5e-3)
        close(a.t, b.t, 5e-3)
    close(points, ref_points, 1e-2)


def test_try_run_ba_guard():
    _, _, po, pt, vi, pi_, x = make_problem(8, 3, 40)
    jposes = jax_poses(po)
    poses = poses_from_numpy(jposes)
    # too few observations for the unknowns: the inputs come back
    keep = np.zeros(len(vi), bool)
    keep[np.unique(pi_, return_index=True)[1]] = True
    keep[np.unique(vi, return_index=True)[1]] = True
    args = (vi[keep], pi_[keep], poses, pt, x[keep])
    assert not api.can_run_ba(3, len(pt), int(keep.sum()))
    with pytest.warns(RuntimeWarning):
        out_poses, out_points = api.try_run_ba(*args, device="cpu")
    assert out_poses is poses and out_points is pt
    # duplicate (viewpoint, point) pairs and unused points are refused
    with pytest.raises(AssertionError):
        api.try_run_ba(np.r_[vi, vi[:1]], np.r_[pi_, pi_[:1]], poses, pt,
                       np.r_[x, x[:1]], device="cpu")
    with pytest.raises(AssertionError):
        api.try_run_ba(vi, pi_, poses, np.r_[pt, pt[:1]], x, device="cpu")
    # enough observations: the same as JAX's guarded run
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ref_poses, ref_points = japi.try_run_ba(vi, pi_, jposes, pt, x)
        out_poses, out_points = api.try_run_ba(vi, pi_, poses, pt, x,
                                               device="cpu")
    close(out_points, ref_points, 1e-2)
    for a, b in zip(out_poses, ref_poses):
        close(a.R, b.R, 5e-3)
