"""Parity of the port's parallel paths (``tadataka_torch/parallel``) with
the JAX package's, on the CPU.

JAX runs on the 8-device CPU mesh that ``tests/conftest.py`` sets up; the
port runs its meshes of CPU shards (``make_mesh(["cpu"] * n)``: one
device repeated, each shard a block of its own).  Both get the same
seeded numpy inputs.  The port's sharded forms are held bit for bit to
its own one-device forms, and to the JAX package within the tolerances
stated in each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tadataka_tpu.ba.residuals import transform_project as jtransform_project
from tadataka_tpu.camera import CameraParameters as JCameraParameters
from tadataka_tpu.core.pose import Pose as JPose
from tadataka_tpu.dataset import PlaneSceneDataset as JPlaneSceneDataset
from tadataka_tpu.dataset.synthetic import (
    multi_plane_scene as jmulti_plane_scene)
from tadataka_tpu.parallel import make_mesh as jmake_mesh
from tadataka_tpu.parallel import (
    distributed_lm_solve as jdistributed_lm_solve,
    sharded_update_depth as jsharded_update_depth,
    shard_observations as jshard_observations)
from tadataka_tpu.parallel.sharded_semi_dense import (
    _regularize_halo as j_regularize_halo,
    make_sharded_update_sweep as jmake_sharded_update_sweep)
from tadataka_tpu.vo.semi_dense import SemiDenseParams as JParams
from tadataka_tpu.vo.semi_dense import regularize as jregularize
from tadataka_tpu.vo.semi_dense import make_frame as jmake_frame
from tadataka_tpu.vo.semi_dense.fast import plan_update as jplan_update
from tadataka_tpu.vo.semi_dense.frame import stack_frames as jstack
from tadataka_tpu.vo.semi_dense.sweep import (
    update_depth_sweep as jupdate_depth_sweep)

from tadataka_torch import interop
from tadataka_torch.ba.residuals import (
    projection_residuals, transform_project)
from tadataka_torch.ba.schur import lm_solve
from tadataka_torch.flags import Flag
from tadataka_torch.parallel import (
    distributed_lm_solve, make_host_mesh, make_mesh,
    make_sharded_update_sweep, initialize_distributed, shard_observations,
    sharded_update_depth)
from tadataka_torch.parallel.mesh import (
    Mesh, neighbour_columns, psum, replicate, shard, unshard)
from tadataka_torch.parallel.multihost import local_slice
from tadataka_torch.parallel.sharded_semi_dense import _regularize_halo
from tadataka_torch.vo.semi_dense import regularize, update_depth
from tadataka_torch.vo.semi_dense.fast import plan_update
from tadataka_torch.vo.semi_dense.sweep import update_depth_sweep


def t(a, dtype=torch.float32):
    return interop.tensor(a, dtype=dtype)


def cpu_mesh(n):
    return make_mesh(["cpu"] * n)


def port_inputs(kf, refs, jparams, age, prior, var):
    return (interop.frame_from_numpy(*kf), interop.frame_from_numpy(*refs),
            t(age, torch.int32), t(prior), t(var),
            interop.params_from_numpy(jparams))


# ------------------------------------------------------------ the mesh

def test_mesh_blocks_and_collectives():
    """shard / unshard round trip, replicate shares one copy a device,
    psum adds in shard order, neighbour columns are zero at the ends."""
    mesh = cpu_mesh(4)
    assert mesh.shape == {"shard": 4} and mesh.size == 4
    assert not mesh.spans_processes
    x = torch.arange(24.0).reshape(2, 12)
    blocks = shard(mesh, x, 1)
    assert [tuple(b.shape) for b in blocks] == [(2, 3)] * 4
    assert all(b.is_contiguous() and b.untyped_storage().data_ptr()
               != x.untyped_storage().data_ptr() for b in blocks)
    assert torch.equal(unshard(mesh, blocks, 1), x)
    copies = replicate(mesh, (x, None))
    assert all(c[0] is copies[0][0] for c in copies)
    total = psum(mesh, [torch.full((2,), float(i)) for i in range(4)])
    assert all(torch.equal(s, torch.full((2,), 6.0)) for s in total)
    halos = neighbour_columns(mesh, blocks)
    assert torch.equal(halos[0][0], torch.zeros(2, 1))
    assert torch.equal(halos[3][1], torch.zeros(2, 1))
    for i in range(1, 4):
        assert torch.equal(halos[i][0], blocks[i - 1][:, -1:])
        assert torch.equal(halos[i - 1][1], blocks[i][:, :1])
    with pytest.raises(ValueError):
        shard(mesh, torch.zeros(2, 10), 1)


def test_make_mesh_needs_a_card_by_default():
    """No CPU fallback: the default mesh is the CUDA devices."""
    if torch.cuda.is_available():
        assert make_mesh().local_devices[0].type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            make_mesh()


def test_multihost_scaffold_single_process():
    """One process: a no-op init, a (1, n) host mesh and the whole
    length for this host; the JAX scaffold's own checks."""
    assert initialize_distributed() == (0, 1)
    mesh = make_host_mesh(["cpu"] * 8)
    assert mesh.axis_names == ("host", "shard")
    assert mesh.shape == {"host": 1, "shard": 8}
    assert local_slice(mesh, 32) == (0, 32)
    assert local_slice(Mesh([["cpu"]] * 3, ("host", "shard"),
                            [[0], [1], [2]]), 11) == (0, 4)


# ----------------------------------------------- column-block sweep

H, W = 48, 64
FOCAL = (64.0, 64.0)


def _sweep_scene(n_refs):
    """The JAX test's 48x64 two-frame scene (n_refs=1), or a 3-refframe
    lateral history with ages 0-3 (n_refs=3)."""
    if n_refs == 1:
        poses = [JPose.identity(),
                 JPose.from_rotvec(jnp.array([0.0, 0.004, 0.0]),
                                   jnp.array([0.25, 0.02, 0.03]))]
    else:
        poses = [JPose.from_rotvec(jnp.float32([0.0, 0.004 * i, 0.0]),
                                   jnp.float32([0.08 * i, 0.01 * i,
                                                0.02 * i]))
                 for i in range(4)]
    ds = jmulti_plane_scene(n_frames=len(poses), image_shape=(H, W),
                            focal_length=FOCAL, poses=poses)
    frames = [ds[i] for i in range(len(poses))]
    key = frames[0] if n_refs == 1 else frames[-1]
    others = frames[1:] if n_refs == 1 else frames[:-1]
    cam = JCameraParameters.create(FOCAL, (W / 2, H / 2))
    jparams = JParams.create(2.0, 50.0, ref_step_size=0.002,
                             min_gradient=0.01)
    kf = jmake_frame(cam, key.image, key.pose.T)
    refs = jstack([jmake_frame(cam, f.image, f.pose.T) for f in others])
    rng = np.random.default_rng(3939)
    gt = np.asarray(key.depth_map)
    prior = (gt + rng.uniform(-0.5, 0.5, gt.shape)).astype(np.float32)
    var = np.full((H, W), 0.05, np.float32)
    age = np.ones((H, W), np.int32) if n_refs == 1 else \
        rng.integers(0, 4, (H, W)).astype(np.int32)
    return kf, refs, jparams, age, prior, var


@pytest.fixture(scope="module")
def pair_scene():
    return _sweep_scene(1)


@pytest.mark.parametrize("n_refs,n", [(1, 2), (1, 8), (3, 4)])
def test_update_depth_sweep_col_offset(n_refs, n):
    """Every column block of update_depth_sweep(col_offset=) is
    torch.equal to the same columns of the whole-map update (the 3-refframe
    history runs per-refframe plane counts and a redirect)."""
    kf, refs, jparams, age, prior, var = _sweep_scene(n_refs)
    pkf, prefs, page, pprior, pvar, params = port_inputs(
        kf, refs, jparams, age, prior, var)
    n_planes, redirect = ((32,), None) if n_refs == 1 else \
        ((48, 32, 32), (1, 1, 2))
    whole = update_depth_sweep(pkf, prefs, page, pprior, pvar, params,
                               n_planes=n_planes, redirect=redirect)
    assert (whole[2] == int(Flag.SUCCESS)).float().mean() > 0.1
    w = W // n
    for i in range(n):
        c = slice(i * w, (i + 1) * w)
        block = update_depth_sweep(
            pkf, prefs, page[:, c], pprior[:, c], pvar[:, c], params,
            n_planes=n_planes, redirect=redirect, col_offset=i * w)
        for b, m in zip(block, whole):
            assert torch.equal(b, m[:, c]), i


@pytest.fixture(scope="module")
def sharded_sweeps(pair_scene):
    kf, refs, jparams, age, prior, var = pair_scene
    plan = jplan_update(kf, refs, jparams)
    jf = jmake_sharded_update_sweep(jmake_mesh(), (H, W), plan,
                                    regularize=True, use_pallas=False)
    jout = tuple(np.asarray(x) for x in jf(
        kf, refs, jnp.asarray(age), jnp.asarray(prior), jnp.asarray(var),
        jparams))
    inputs = port_inputs(kf, refs, jparams, age, prior, var)
    pplan = plan_update(inputs[0], inputs[1], inputs[5])
    mesh = cpu_mesh(8)
    out = tuple(unshard(mesh, b, 1) for b in make_sharded_update_sweep(
        mesh, (H, W), pplan)(*inputs))
    return plan, pplan, inputs, out, jout


def test_sharded_sweep_matches_single_device(sharded_sweeps):
    """8 column shards + the halo regularization: torch.equal to the
    port's one-device update_depth_sweep + regularize."""
    plan, pplan, inputs, (d8, v8, f8), _ = sharded_sweeps
    assert pplan.path == plan.path == 'tent'
    assert pplan.n_planes == plan.n_planes
    assert pplan.redirect == plan.redirect
    d1, v1, f1 = update_depth_sweep(*inputs, n_planes=pplan.n_planes,
                                    redirect=pplan.redirect)
    assert torch.equal(f8, f1)
    assert torch.equal(v8, v1)
    assert torch.equal(d8, regularize(d1, v1, f1))


def test_sharded_sweep_matches_jax(sharded_sweeps, pair_scene):
    """Against JAX's sharded sweep (its tent warps, ``use_pallas=False``).
    The tent warps mark lanes past their budget invalid and the port's
    gathers have none, so the maps are compared where both are SUCCESS
    and the flag lanes that differ are counted: at most 0.5% of the map
    (measured: none).  Where both succeed the variance is held to the JAX
    test's 1e-5 on every pixel.  The regularized depth is held by the
    quantiles of its relative difference, against the gap between JAX's
    own two forms on this scene (its one-device gather sweep, the form
    the port implements, beside its sharded tent sweep): each quantile
    (median, 90th, 99th) at most 1.5x that gap's and below 2e-4, 2e-3,
    2e-2 (measured: port 1.03e-4, 6.8e-4, 1.08e-2; gap 9.6e-5, 7.5e-4,
    1.21e-2).  The window argmin of a flat error curve moves a plane
    where the samples differ by an ulp (test_torch_sweep.py), so the JAX
    test's own rtol 1e-4 holds on only ~75% of the pixels even between
    JAX's two forms."""
    _, _, _, out, jout = sharded_sweeps
    kf, refs, jparams, age, prior, var = pair_scene
    plan = jplan_update(kf, refs, jparams)
    jgather = jregularize(*jupdate_depth_sweep(
        kf, refs, jnp.asarray(age), jnp.asarray(prior), jnp.asarray(var),
        jparams, n_planes=plan.n_planes, use_pallas=False, warp_budget=0,
        key_budget=0, redirect=plan.redirect))
    (d, v, f), (jd, jv, jf) = (x.numpy() for x in out), jout
    assert np.mean(f != jf) <= 0.005, np.mean(f != jf)
    both = (f == 0) & (jf == 0)
    assert both.mean() > 0.2, both.mean()
    np.testing.assert_allclose(v[both], jv[both], rtol=1e-5, atol=1e-5)

    def quantiles(a):
        rel = np.abs(a - jd)[both] / np.abs(jd[both])
        return np.quantile(rel, [0.5, 0.9, 0.99])

    port, gap = quantiles(d), quantiles(np.asarray(jgather))
    assert np.all(port <= 1.5 * gap), (port, gap)
    assert np.all(port <= [2e-4, 2e-3, 2e-2]), port


def _halo_maps():
    gen = np.random.default_rng(3)
    depth = (10.0 + gen.normal(0, 0.5, (H, W))).astype(np.float32)
    variance = gen.uniform(0.01, 0.2, (H, W)).astype(np.float32)
    flags = np.where(gen.random((H, W)) < 0.7, 0, -6).astype(np.int32)
    return depth, variance, flags


def test_regularize_halo():
    """Column-sharded halo smoothing: torch.equal to the port's regularize
    on the whole map, and within rtol 1e-6 of JAX's _regularize_halo on
    its 8-device mesh (the tolerance of test_torch_semi_dense.py's
    regularize parity)."""
    depth, variance, flags = _halo_maps()
    mesh = cpu_mesh(8)
    blocks = [shard(mesh, x, 1) for x in (t(depth), t(variance),
                                          t(flags, torch.int32))]
    out = unshard(mesh, _regularize_halo(mesh, *blocks), 1)
    assert torch.equal(out, regularize(t(depth), t(variance),
                                       t(flags, torch.int32)))
    jmesh = jmake_mesh()
    jf = jax.jit(jax.shard_map(
        lambda d, v, f: j_regularize_halo(d, v, f, "shard"), mesh=jmesh,
        in_specs=(P(None, "shard"),) * 3, out_specs=P(None, "shard")))
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jf(depth, variance, flags)),
                               rtol=1e-6)


# ------------------------------------------------- row-sharded update

def test_sharded_update_depth_matches():
    """The JAX test's 64x80 plane scene, 8 row shards: torch.equal to the
    port's one-device update_depth; against JAX's sharded update, flags
    on >= 99.5% of pixels and, where both are SUCCESS, the median
    relative depth difference <= 5e-5 (the ceilings of
    test_torch_estimator.py's update_depth parity)."""
    Hs, Ws = 64, 80
    poses = [JPose.identity(),
             JPose.from_rotvec(jnp.zeros(3), jnp.array([0.5, 0.0, 0.0]))]
    ds = JPlaneSceneDataset(n_frames=2, image_shape=(Hs, Ws),
                            focal_length=FOCAL, poses=poses)
    key, ref = ds[0], ds[1]
    cam = JCameraParameters.create(FOCAL, (Ws / 2, Hs / 2))
    kf = jmake_frame(cam, key.image, key.pose.T)
    refs = jstack([jmake_frame(cam, ref.image, ref.pose.T)])
    jparams = JParams.create(2.0, 50.0, ref_step_size=0.002,
                             min_gradient=0.01)
    rng = np.random.default_rng(3939)
    gt = np.asarray(key.depth_map)
    prior = (gt + rng.uniform(-1, 1, gt.shape)).astype(np.float32)
    var = np.full((Hs, Ws), 0.05, np.float32)
    age = np.ones((Hs, Ws), np.int32)

    jd, jv, jf = (np.asarray(x) for x in jsharded_update_depth(
        jmake_mesh(), kf, refs, jnp.asarray(age), jnp.asarray(prior),
        jnp.asarray(var), jparams, n_ref_samples=64))
    inputs = port_inputs(kf, refs, jparams, age, prior, var)
    mesh = cpu_mesh(8)
    d8, v8, f8 = (unshard(mesh, b) for b in sharded_update_depth(
        mesh, *inputs, n_ref_samples=64))
    d1, v1, f1 = update_depth(*inputs, n_ref_samples=64)
    assert torch.equal(d8, d1) and torch.equal(v8, v1)
    assert torch.equal(f8, f1)
    f, d = f8.numpy(), d8.numpy()
    assert np.mean(f == jf) >= 0.995, np.mean(f == jf)
    both = (f == 0) & (jf == 0)
    assert both.mean() > 0.05, both.mean()
    assert np.median(np.abs(d - jd)[both] / jd[both]) <= 5e-5


# ------------------------------------------------ landmark-sharded BA

def _make_scene(rng, n_viewpoints=4, n_points=64):
    """tests/parallel/test_parallel.py's scene (the same draws)."""
    points = rng.uniform(-1, 1, (n_points, 3)).astype(np.float32)
    points[:, 2] += 5.0
    rotvecs = rng.uniform(-0.1, 0.1, (n_viewpoints, 3)).astype(np.float32)
    ts = rng.uniform(-0.5, 0.5, (n_viewpoints, 3)).astype(np.float32)
    poses = np.hstack([rotvecs, ts])
    vi, pi_ = np.meshgrid(np.arange(n_viewpoints), np.arange(n_points))
    vi, pi_ = vi.T.ravel(), pi_.T.ravel()
    x_true = np.asarray(jax.vmap(jtransform_project)(
        jnp.asarray(poses)[vi], jnp.asarray(points)[pi_])).astype(np.float32)
    return poses, points, vi, pi_, x_true


def _mse(poses, points, vi, pi_, x_true):
    r = projection_residuals(poses, points, torch.as_tensor(vi),
                             torch.as_tensor(pi_), t(x_true))
    return float(torch.mean(torch.sum(r * r, dim=-1)))


@pytest.fixture(scope="module")
def ba_scene():
    rng = np.random.default_rng(3939)
    poses, points, vi, pi_, x_true = _make_scene(rng)
    poses_noisy = (poses + rng.normal(0, 0.01, poses.shape)).astype(
        np.float32)
    points_noisy = (points + rng.normal(0, 0.05, points.shape)).astype(
        np.float32)
    return poses_noisy, points_noisy, vi, pi_, x_true


def test_shard_observations_matches(ba_scene):
    """The host layout equals JAX's array for array, also uneven."""
    _, _, vi, pi_, x_true = ba_scene
    for n_points, n_dev in ((64, 8), (64, 3), (37, 8)):
        keep = pi_ < n_points
        port = shard_observations(vi[keep], pi_[keep], x_true[keep],
                                  n_points, n_dev)
        ref = jshard_observations(vi[keep], pi_[keep], x_true[keep],
                                  n_points, n_dev)
        for a, b in zip(port[:4], ref[:4]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert port[4] == ref[4]


def test_distributed_ba_matches_jax_and_single_device(ba_scene):
    """8 landmark shards, max_iter=30: converges (mean squared
    reprojection error < 1e-6, the JAX test's gate); the same basin as
    JAX's distributed_lm_solve (errors within 1e-5 of each other, the
    JAX test's single-vs-distributed bound) with poses within 1e-3 (the
    gauge is held by the same start and schedule; measured 3e-6) and the
    reprojections within 1e-4; and as the port's one-device lm_solve.
    A one-shard mesh is bit-equal to lm_solve: the same sums in the same
    order."""
    poses_noisy, points_noisy, vi, pi_, x_true = ba_scene
    new_poses, new_points, err = distributed_lm_solve(
        cpu_mesh(8), poses_noisy, points_noisy, vi, pi_, x_true,
        max_iter=30)
    e_dist = _mse(new_poses, new_points, vi, pi_, x_true)
    assert e_dist < 1e-6 and float(err) < 1e-6

    jposes, jpoints, jerr = jdistributed_lm_solve(
        jmake_mesh(), poses_noisy, points_noisy, vi, pi_, x_true,
        max_iter=30)
    assert abs(e_dist - float(jerr)) < 1e-5
    np.testing.assert_allclose(new_poses.numpy(), np.asarray(jposes),
                               atol=1e-3)
    x_port = transform_project(new_poses[vi], new_points[pi_]).numpy()
    x_jax = np.asarray(jax.vmap(jtransform_project)(
        jposes[vi], jpoints[pi_]))
    np.testing.assert_allclose(x_port, x_jax, atol=1e-4)

    args = (t(poses_noisy), t(points_noisy), torch.as_tensor(vi),
            torch.as_tensor(pi_), t(x_true))
    sp, spt, serr = lm_solve(*args, max_iter=30)
    assert abs(e_dist - _mse(sp, spt, vi, pi_, x_true)) < 1e-5
    p1, x1, e1 = distributed_lm_solve(cpu_mesh(1), poses_noisy,
                                      points_noisy, vi, pi_, x_true,
                                      max_iter=30)
    assert torch.equal(p1, sp) and torch.equal(x1, spt)
    assert float(e1) == float(serr)


def test_distributed_ba_uneven_points():
    """37 points over 8 shards (padding in the last), max_iter=5, as the
    JAX test: the right shape, finite, and an error within 1e-5 of
    JAX's on the same scene."""
    rng = np.random.default_rng(3939)
    poses, points, vi, pi_, x_true = _make_scene(rng, n_points=37)
    new_poses, new_points, err = distributed_lm_solve(
        cpu_mesh(8), poses, points, vi, pi_, x_true, max_iter=5)
    assert tuple(new_points.shape) == (37, 3)
    assert torch.isfinite(new_points).all()
    _, _, jerr = jdistributed_lm_solve(jmake_mesh(), poses, points, vi,
                                       pi_, x_true, max_iter=5)
    assert abs(float(err) - float(jerr)) < 1e-5
