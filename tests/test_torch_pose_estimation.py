"""Parity of the port's geometry (``core/{solvers,triangulation}.py``,
``pose_estimation/{epipolar,p3p,epnp,pnp}.py``) with the JAX package's,
on the CPU, on seeded scenes: points in a 2 m cube 4-6 m ahead, seen
from a second pose, their normalized projections with seeded noise and
outliers.  The RANSAC draws are the JAX package's own (``jax.random.
uniform`` of ``PRNGKey(3939)``, the key of every site here).

Tolerances: null vectors up to sign within 1e-5; E up to sign and scale
within 1e-4; triangulated points, depths and poses within 1e-4 (their
scale is 1-6); inlier masks equal.  SVD, eigh and solve round by
library, so nothing past the first factorization is bit-equal.  Two
solvers amplify that rounding, and are held looser: EPnP's float32
eigendecompositions (the JAX package's own tests hold its poses to 2e-3
of the truth) within 2e-3 (R) and 5e-3 (t), and on minimal samples by
the distribution of its errors; P3P, where a near-double quartic root can
polish to another solution, per scene on 90% of the scenes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal
from scipy.spatial.transform import Rotation

from tadataka_tpu.core import solvers as jsolvers
from tadataka_tpu.core import transforms as jtransforms
from tadataka_tpu.core import triangulation as jtri
from tadataka_tpu.core.pose import Pose as JPose
from tadataka_tpu.pose_estimation import epipolar as jepi
from tadataka_tpu.pose_estimation import epnp as jepnp
from tadataka_tpu.pose_estimation import p3p as jp3p
from tadataka_tpu.pose_estimation import pnp as jpnp

from tadataka_torch.core import solvers, transforms, triangulation
from tadataka_torch.core.pose import Pose
from tadataka_torch.pose_estimation import epipolar, epnp, p3p, pnp
from tadataka_torch.utils.exceptions import NotEnoughInliersException


def jax_uniform(site, shape):
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(3939), shape))


def T(a, dtype=None):
    return torch.tensor(np.array(a), dtype=dtype)


def close(a, b, atol=1e-4):
    assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol)


def scene(seed, n=120, planar=False, noise=0.0, outliers=0):
    """(points, R, t, x0, x1): world points, the second camera's pose
    (world -> camera) and both views' normalized projections; the first
    camera is the identity."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    pts[:, 2] = 0.0 if planar else pts[:, 2]
    pts[:, 2] += 5.0
    R = Rotation.from_rotvec(rng.uniform(-0.1, 0.1, 3)).as_matrix()
    t = np.array([0.5, 0.1, -0.1]) + rng.uniform(-0.1, 0.1, 3)
    R, t = R.astype(np.float32), t.astype(np.float32)
    p1 = pts @ R.T + t
    x0 = pts[:, :2] / pts[:, 2:3]
    x1 = p1[:, :2] / p1[:, 2:3]
    x1 = x1 + rng.normal(0, noise, x1.shape)
    x1[:outliers] += rng.uniform(0.05, 0.2, (outliers, 2))
    return pts, R, t, x0.astype(np.float32), x1.astype(np.float32)


def same_up_to_sign(a, b, atol):
    a, b = np.asarray(a), np.asarray(b)
    sign = np.where(np.sum(a * b, axis=-1, keepdims=True) < 0, -1.0, 1.0)
    assert_allclose(a * sign, b, rtol=0, atol=atol)


def test_transforms():
    """The homogeneous and batched transforms the feature VO's modules
    added to ``core/transforms.py``."""
    rng = np.random.default_rng(13)
    Rs = Rotation.from_rotvec(rng.uniform(-1, 1, (4, 3))).as_matrix()
    Rs = Rs.astype(np.float32)
    ts = rng.normal(size=(4, 3)).astype(np.float32)
    pts = rng.normal(size=(4, 3)).astype(np.float32)
    j = [jnp.asarray(a) for a in (Rs, ts, pts)]
    for name in ("transform_each", "transform_all", "inv_transform_all"):
        close(getattr(transforms, name)(T(Rs), T(ts), T(pts)),
              getattr(jtransforms, name)(*j), 1e-6)
    close(transforms.rotate_each(T(Rs), T(pts)),
          jtransforms.rotate_each(j[0], j[2]), 1e-6)
    h = transforms.to_homogeneous(T(pts))
    assert_array_equal(h.numpy(), np.asarray(jtransforms.to_homogeneous(
        j[2])))
    assert_array_equal(transforms.from_homogeneous(h).numpy(), pts)
    Ta = jtransforms.motion_matrix(j[0][0], j[1][0])
    Tb = jtransforms.motion_matrix(j[0][1], j[1][1])
    close(transforms.relative_transform(T(Ta), T(Tb)),
          jtransforms.relative_transform(Ta, Tb), 1e-6)


@pytest.mark.parametrize("shape", [(8, 9), (30, 9), (5, 4, 4), (12, 12)])
def test_solve_nullspace(shape):
    A = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    same_up_to_sign(solvers.solve_nullspace(T(A)).numpy(),
                    jsolvers.solve_nullspace(jnp.asarray(A)), 1e-5)


def test_linear_solvers():
    rng = np.random.default_rng(1)
    J = rng.normal(size=(40, 6)).astype(np.float32)
    r = rng.normal(size=40).astype(np.float32)
    w = rng.random(40).astype(np.float32)
    close(solvers.solve_linear_equation(T(J), T(r), T(w), 0.1),
          jsolvers.solve_linear_equation(jnp.asarray(J), jnp.asarray(r),
                                         jnp.asarray(w), 0.1), 1e-5)
    close(solvers.solve_lstsq(T(J), T(r)),
          jsolvers.solve_lstsq(jnp.asarray(J), jnp.asarray(r)), 1e-5)
    close(solvers.weighted_mean(T(r), T(w)),
          jsolvers.weighted_mean(jnp.asarray(r), jnp.asarray(w)), 1e-6)


def test_triangulation():
    pts, R, t, x0, x1 = scene(2, noise=1e-3)
    R2 = Rotation.from_rotvec([0.0, -0.05, 0.02]).as_matrix().astype(
        np.float32)
    t2 = np.array([-0.4, 0.0, 0.1], np.float32)
    p2 = pts @ R2.T + t2
    x2 = (p2[:, :2] / p2[:, 2:3]).astype(np.float32)
    Rs = np.stack([np.eye(3, dtype=np.float32), R, R2])
    ts = np.stack([np.zeros(3, np.float32), t, t2])
    kps = np.stack([x0, x1, x2])
    ref = jtri.linear_triangulation(jnp.asarray(Rs), jnp.asarray(ts),
                                    jnp.asarray(kps))
    out = triangulation.linear_triangulation(T(Rs), T(ts), T(kps))
    close(out[0], ref[0])
    close(out[1], ref[1])
    close(out[0], pts, 0.2)

    jp0, jp1 = JPose(jnp.eye(3), jnp.zeros(3)), JPose(jnp.asarray(R),
                                                      jnp.asarray(t))
    p0, p1 = Pose(torch.eye(3), torch.zeros(3)), Pose(T(R), T(t))
    ref = jtri.two_view_triangulation(jp0, jp1, jnp.asarray(x0),
                                      jnp.asarray(x1))
    out = triangulation.two_view_triangulation(p0, p1, T(x0), T(x1))
    close(out[0], ref[0])
    close(out[1], ref[1])

    # a different first pose per row
    rows = np.arange(len(pts)) % 2 == 0
    R0 = np.where(rows[:, None, None], np.eye(3, dtype=np.float32), R2)
    t0 = np.where(rows[:, None], 0.0, t2).astype(np.float32)
    k0 = np.where(rows[:, None], x0, x2)
    ref = jtri.pairwise_triangulation(jnp.asarray(R0), jnp.asarray(t0),
                                      jnp.asarray(R), jnp.asarray(t),
                                      jnp.asarray(k0), jnp.asarray(x1))
    out = triangulation.pairwise_triangulation(T(R0), T(t0), T(R), T(t),
                                               T(k0), T(x1))
    close(out[0], ref[0])
    close(out[1], ref[1])

    mask = triangulation.compute_depth_mask(out[1], 4.5)
    assert_array_equal(mask.numpy(),
                       np.asarray(jtri.compute_depth_mask(ref[1], 4.5)))
    assert bool(triangulation.depth_condition(mask, 0.3)) == bool(
        jtri.depth_condition(jtri.compute_depth_mask(ref[1], 4.5), 0.3))

    close(triangulation.depths_from_triangulation(p0, p1, T(x0[3]),
                                                  T(x1[3])),
          jtri.depths_from_triangulation(jp0, jp1, jnp.asarray(x0[3]),
                                         jnp.asarray(x1[3])))
    # depth of x0 from camera -> world poses (the inverse of p0 and p1)
    close(triangulation.calc_depth0_poses(p0.inv(), p1.inv(), T(x0), T(x1)),
          jtri.calc_depth0_poses(jp0.inv(), jp1.inv(), jnp.asarray(x0),
                                 jnp.asarray(x1)), 1e-3)
    close(triangulation.calc_depth0(p1.T, T(x0), T(x1)),
          jtri.calc_depth0(jp1.T, jnp.asarray(x0), jnp.asarray(x1)), 1e-3)


@pytest.mark.parametrize("masked", [False, True])
def test_estimate_fundamental(masked):
    _, _, _, x0, x1 = scene(3, noise=5e-4)
    mask = (np.arange(len(x0)) % 4 != 0) if masked else None
    ref = jepi.estimate_fundamental(jnp.asarray(x0), jnp.asarray(x1),
                                    None if mask is None
                                    else jnp.asarray(mask))
    out = epipolar.estimate_fundamental(T(x0), T(x1),
                                        None if mask is None else T(mask))
    ref = np.asarray(ref).ravel() / np.linalg.norm(ref)
    out = out.numpy().ravel() / np.linalg.norm(out.numpy())
    same_up_to_sign(out, ref, 1e-4)


def test_decompose_essential_and_select():
    _, R, t, x0, x1 = scene(4)
    E = epipolar.estimate_fundamental(T(x0), T(x1))
    cands = epipolar.decompose_essential(E)
    ref = jepi.decompose_essential(jnp.asarray(E.numpy()))
    # the SVD's sign choices may swap R1 and R2 and negate t: compare sets
    for R_ in cands[:2]:
        assert min(np.abs(R_.numpy() - np.asarray(r)).max()
                   for r in ref[:2]) < 1e-4
    same_up_to_sign(cands[2].numpy(), np.asarray(ref[2]), 1e-4)
    for R_ in cands[:2]:
        assert abs(np.linalg.det(R_.numpy()) - 1.0) < 1e-4
    # the vote over the same four candidates
    ref = jepi.select_valid_pose(*ref, jnp.asarray(x0), jnp.asarray(x1))
    jcands = [T(np.asarray(c)) for c in jepi.decompose_essential(
        jnp.asarray(E.numpy()))]
    out = epipolar.select_valid_pose(*jcands, T(x0), T(x1))
    close(out[0], ref[0], 1e-6)
    close(out[1], ref[1], 1e-6)
    close(out[0], R, 1e-3)


def test_estimate_pose_change():
    _, R, t, x0, x1 = scene(5, noise=2e-4, outliers=15)
    ref = jepi.estimate_pose_change(jnp.asarray(x0), jnp.asarray(x1))
    out = epipolar.estimate_pose_change(T(x0), T(x1), rng=jax_uniform)
    close(out.R, ref.R)
    close(out.t, ref.t)
    close(out.t, t / np.linalg.norm(t), 0.02)
    # the masks of the RANSAC stage
    key = jax.random.PRNGKey(3939)
    mask = np.ones(len(x0), bool)
    _, in_ref = jepi._estimate_pose_change_ransac(
        jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(mask), key, 0.002, 256)
    _, inliers = epipolar._estimate_pose_change_ransac(
        T(x0), T(x1), T(mask), jax_uniform, 0.002, 256)
    assert_array_equal(inliers.numpy(), np.asarray(in_ref))
    assert not inliers[:15].any()
    ref = jepi.estimate_pose_change_lstsq(jnp.asarray(x0[15:]),
                                          jnp.asarray(x1[15:]))
    out = epipolar.estimate_pose_change_lstsq(T(x0[15:]), T(x1[15:]))
    close(out.R, ref.R)
    close(out.t, ref.t)


def test_solve_quartic():
    rng = np.random.default_rng(6)
    coeffs = rng.normal(0, 2, (200, 5)).astype(np.float32)
    coeffs[:, 0] = np.sign(coeffs[:, 0]) * np.maximum(np.abs(coeffs[:, 0]),
                                                      0.3)
    ref_roots, ref_valid = jax.vmap(jp3p.solve_quartic)(
        *(jnp.asarray(c) for c in coeffs.T))
    roots, valid = p3p.solve_quartic(*(T(c) for c in coeffs.T))
    assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    scale = np.maximum(1.0, np.abs(np.asarray(ref_roots)))
    assert (np.abs(roots.numpy() - np.asarray(ref_roots)) / scale
            < 1e-4).all()


def p3p_scenes(seed, n_scenes=40, n=4):
    rng = np.random.default_rng(seed)
    points = rng.uniform(-1, 1, (n_scenes, n, 3)).astype(np.float32)
    points[..., 2] += 4.0
    R = Rotation.from_rotvec(rng.uniform(-0.5, 0.5, (n_scenes, 3)))
    R = R.as_matrix().astype(np.float32)
    t = rng.uniform(-1, 1, (n_scenes, 3)).astype(np.float32)
    P = np.einsum('sij,snj->sni', R, points) + t[:, None]
    return points, (P[..., :2] / P[..., 2:3]).astype(np.float32), R, t


def test_p3p():
    """40 random scenes: the valid lanes equal; each scene's valid
    solutions and chosen pose within 1e-3 of JAX's on 90% of the scenes
    (a near-double root can polish to another solution); and wherever
    JAX's chosen pose is the truth (within 1e-3), so is the port's."""
    points, kps, R, t = p3p_scenes(7)
    ref = jax.vmap(jp3p.p3p_solutions)(jnp.asarray(points[:, :3]),
                                       jnp.asarray(kps[:, :3]))
    out = p3p.p3p_solutions(T(points[:, :3]), T(kps[:, :3]))
    valid = np.asarray(ref[2])
    assert_array_equal(out[2].numpy(), valid)
    assert valid.sum() > 40
    dR = np.abs(out[0].numpy() - np.asarray(ref[0])).max(axis=(-1, -2))
    dt = np.abs(out[1].numpy() - np.asarray(ref[1])).max(axis=-1)
    agree = np.all(~valid | ((dR < 1e-3) & (dt < 1e-3)), axis=1)
    assert agree.mean() >= 0.9, agree
    ref_R, ref_t = jax.vmap(jp3p.p3p_best_pose)(jnp.asarray(points),
                                                jnp.asarray(kps))
    out_R, out_t = p3p.p3p_best_pose(T(points), T(kps))
    err = np.abs(out_R.numpy() - np.asarray(ref_R)).max(axis=(1, 2))
    assert (err < 1e-3).mean() >= 0.9, err
    truth = np.abs(np.asarray(ref_R) - R).max(axis=(1, 2)) < 1e-3
    assert truth.mean() >= 0.9
    assert (np.abs(out_R.numpy() - R).max(axis=(1, 2))[truth] < 1e-3).all()
    assert (np.abs(out_t.numpy() - t).max(axis=1)[truth] < 1e-3).all()


@pytest.mark.parametrize("planar", [False, True])
@pytest.mark.parametrize("n", [5, 40])
def test_epnp_pose(planar, n):
    pts, R, t, _, x1 = scene(8, n=n, planar=planar)
    ref = jepnp.epnp_pose(jnp.asarray(pts), jnp.asarray(x1))
    out = epnp.epnp_pose(T(pts), T(x1))
    close(out[0], ref[0], 2e-3)
    close(out[1], ref[1], 5e-3)
    close(out[0], R, 2e-3)
    close(out[1], t, 5e-3)


def test_epnp_batched():
    """64 five-point samples of exact data, as RANSAC passes them, against
    the JAX solver vmapped over them.  EPnP on five points is
    ill-conditioned in float32 in both packages (a median rotation error
    of 1.1e-3 against the truth in each, and up to 1 on a sample with a
    repeated point), so the batch is held by its distribution: the two
    agree within 2e-3 on 70% of the samples, and the port's median error
    against the truth is within 25% of JAX's."""
    pts, R, _, _, x1 = scene(9, n=50)
    idx = np.random.default_rng(9).integers(0, 50, (64, 5))
    ref = jax.vmap(jepnp.epnp_pose)(jnp.asarray(pts[idx]),
                                    jnp.asarray(x1[idx]))
    out = epnp.epnp_pose(T(pts[idx]), T(x1[idx]))
    d = np.abs(out[0].numpy() - np.asarray(ref[0])).max(axis=(1, 2))
    assert (d < 2e-3).mean() >= 0.7, d
    err_ref = np.abs(np.asarray(ref[0]) - R).max(axis=(1, 2))
    err = np.abs(out[0].numpy() - R).max(axis=(1, 2))
    assert np.median(err) <= 1.25 * np.median(err_ref)


@pytest.mark.parametrize("method", ["epnp", "p3p", "dlt"])
def test_solve_pnp_ransac(method):
    pts, R, t, _, x1 = scene(10, n=100, noise=2e-4, outliers=20)
    mask = np.ones(len(pts), bool)
    mask[-5:] = False
    ref_pose, ref_in = jpnp.solve_pnp_ransac(
        jnp.asarray(pts), jnp.asarray(x1), jnp.asarray(mask),
        jax.random.PRNGKey(3939), reprojection_threshold=0.002,
        method=method)
    pose, inliers = pnp.solve_pnp_ransac(
        T(pts), T(x1), T(mask), jax_uniform, reprojection_threshold=0.002,
        method=method)
    assert_array_equal(inliers.numpy(), np.asarray(ref_in))
    assert not inliers[:20].any() and inliers[20:-5].all()
    close(pose.R, ref_pose.R)
    close(pose.t, ref_pose.t)
    close(pose.R, R, 5e-3)


def test_solve_pnp_adaptive_threshold_and_packed():
    pts, _, _, _, x1 = scene(11, n=80, noise=1e-4, outliers=8)
    mask = np.arange(80) % 5 != 0
    close(pnp.calc_reprojection_threshold(T(x1), mask=T(mask)),
          jpnp.calc_reprojection_threshold(jnp.asarray(x1),
                                           mask=jnp.asarray(mask)), 1e-8)
    close(pnp.calc_reprojection_threshold(T(x1)),
          jpnp.calc_reprojection_threshold(jnp.asarray(x1)), 1e-8)
    ref = jpnp.solve_pnp_packed(pts, x1, mask)
    out = pnp.solve_pnp_packed(pts, x1, mask, rng=jax_uniform, device="cpu")
    close(out[:12], ref[:12])
    assert float(out[12]) == float(ref[12]) > 50
    ref = jpnp.solve_pnp(jnp.asarray(pts), jnp.asarray(x1))
    out = pnp.solve_pnp(T(pts), T(x1), rng=jax_uniform)
    close(out.R, ref.R)
    close(out.t, ref.t)
    with pytest.raises(NotEnoughInliersException):
        pnp.solve_pnp_packed(pts, x1, np.arange(80) < 5, device="cpu")
    with pytest.raises(NotEnoughInliersException):
        pnp.solve_pnp(T(pts[:5]), T(x1[:5]))


def test_gauss_newton_refinement():
    """The masked Gauss-Newton (the closed-form Jacobian and normal
    equations of ``pnp.pnp_normal``) from a perturbed pose, batched,
    against the JAX refinement."""
    pts, R, t, _, x1 = scene(12, n=30, noise=1e-4)
    w = (np.arange(30) % 3 != 0).astype(np.float32)
    R0 = (Rotation.from_rotvec([0.01, -0.02, 0.005]).as_matrix()
          .astype(np.float32) @ R)
    t0 = t + np.float32(0.05)
    ref = jpnp._refine_gauss_newton(jnp.asarray(R0), jnp.asarray(t0),
                                    jnp.asarray(pts), jnp.asarray(x1),
                                    jnp.asarray(w), 6)
    out = pnp._refine_gauss_newton(T(R0)[None].repeat(3, 1, 1),
                                   T(t0)[None].repeat(3, 1), T(pts),
                                   T(x1), T(w), 6)
    for i in range(3):
        close(out[0][i], ref[0], 1e-5)
        close(out[1][i], ref[1], 1e-5)


def _jacfwd_residuals(p, R, t, points, keypoints):
    """The reprojection residuals (2n,) of the pose (exp(p[:3]) R, t +
    p[3:]), through the small-angle branch of exp_so3 (the one taken at
    p = 0)."""
    from tadataka_torch.core.projection import pi
    from tadataka_torch.core.rounding import matmul_small
    from tadataka_torch.core.so3 import exp_so3_small
    Rk = matmul_small(exp_so3_small(p[:3]), R)
    P = matmul_small(points, Rk.transpose(-1, -2)) + (t + p[3:])
    return (pi(P) - keypoints).reshape(-1)


@pytest.mark.parametrize("B,n,zero_weights", [(1, 37, False), (3, 30, True),
                                              (8 * 4, 3, False)])
def test_closed_form_jacobian_equals_jacfwd(B, n, zero_weights):
    """``pnp_jacobian``'s closed form and ``pnp_normal``'s normal
    equations bit for bit against torch.func.jacfwd under vmap and the
    same products summed by fixed_order_sum; (32, 3) is P3P's
    refinement (8 trials, 4 solutions)."""
    from tadataka_torch.core.rounding import fixed_order_sum
    g = np.random.default_rng(B * 1000 + n)
    R = T(Rotation.from_rotvec(g.normal(0, 0.3, (B, 3))).as_matrix(),
          torch.float32)
    t = T(g.normal(0, 0.5, (B, 3)), torch.float32)
    X = T(g.uniform(-1, 1, (B, n, 3)) + [0, 0, 5], torch.float32)
    kp = T(g.normal(0, 0.2, (B, n, 2)), torch.float32)
    w = T(g.random((B, n)), torch.float32)
    if zero_weights:
        w[:, ::3] = 0.0
    J_ref = torch.func.vmap(torch.func.jacfwd(_jacfwd_residuals),
                            in_dims=(None, 0, 0, 0, 0))(
        torch.zeros(6), R, t, X, kp)
    r_ref = torch.func.vmap(_jacfwd_residuals, in_dims=(None, 0, 0, 0, 0))(
        torch.zeros(6), R, t, X, kp)
    r, J = pnp.pnp_jacobian(R, t, X, kp)
    assert torch.equal(J, J_ref) and torch.equal(r, r_ref)
    Jw = (J_ref * w.repeat_interleave(2, -1)[..., None]).transpose(-1, -2)
    normal_ref = fixed_order_sum(Jw[:, :, None, :] * torch.cat(
        [J_ref.transpose(-1, -2), r_ref[:, None, :]], 1)[:, None, :, :])
    assert torch.equal(pnp.pnp_normal(R, t, X, kp, w), normal_ref)
