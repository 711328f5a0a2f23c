"""The port's auxiliary modules against the JAX package's (the
counterpart of ``tests/test_aux.py``): config, checkpoint (across the
two packages), observability, the optimization framework, array
helpers, the native loader and viz (headless)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import matplotlib
matplotlib.use("Agg")

from tadataka_tpu.apps.semi_dense_vo import (
    SemiDenseVOState as JSemiDenseVOState)
from tadataka_tpu.core.pose import Pose as JPose

from tadataka_torch.apps.semi_dense_vo import SemiDenseVOState
from tadataka_torch.core.pose import Pose


def test_config_json_equals_jax(tmp_path):
    """The same JSON text as JAX's, default and edited; a JAX file loads
    into the port's tree."""
    from tadataka_tpu.config import PipelineConfig as JPipelineConfig
    from tadataka_torch.config import PipelineConfig
    assert PipelineConfig().to_json() == JPipelineConfig().to_json()
    cfg, jcfg = PipelineConfig(), JPipelineConfig()
    for c in (cfg, jcfg):
        c.dvo.max_iter = 7
        c.semi_dense.min_depth = 1.5
        c.feature_vo.features.max_keypoints = 256
        c.dvo.weights = None
    assert cfg.to_json() == jcfg.to_json()
    path = tmp_path / "config.json"
    jcfg.to_json(path)
    loaded = PipelineConfig.from_json(str(path))
    assert loaded == cfg
    assert loaded.feature_vo.features.max_keypoints == 256


def _states(H=4, W=5, flags=True):
    """The same SemiDenseVOState in both packages (seeded values)."""
    gen = np.random.default_rng(11)
    R = np.eye(3, dtype=np.float32)
    tr = gen.normal(size=3).astype(np.float32)
    depth = gen.uniform(1, 10, (H, W)).astype(np.float32)
    var = gen.uniform(0, 1, (H, W)).astype(np.float32)
    age = gen.integers(0, 8, (H, W)).astype(np.int32)
    flag = gen.integers(-6, 1, (H, W)).astype(np.int32) if flags else None
    jstate = JSemiDenseVOState(JPose(jnp.asarray(R), jnp.asarray(tr)),
                               jnp.asarray(depth), jnp.asarray(var),
                               jnp.asarray(age),
                               None if flag is None else jnp.asarray(flag))
    state = SemiDenseVOState(Pose(torch.from_numpy(R), torch.from_numpy(tr)),
                             torch.from_numpy(depth), torch.from_numpy(var),
                             torch.from_numpy(age),
                             None if flag is None else torch.from_numpy(flag))
    return jstate, state


def _assert_state_equal(port, jstate):
    """Bit-equal, field by field, with the port's dtypes."""
    assert type(port) is SemiDenseVOState and type(port.pose_wc) is Pose
    for name in ("depth_map", "variance_map", "age_map", "flag_map"):
        a, b = getattr(port, name), getattr(jstate, name)
        if b is None:
            assert a is None
            continue
        assert isinstance(a, torch.Tensor)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert a.numpy().dtype == np.asarray(b).dtype
    np.testing.assert_array_equal(port.pose_wc.R.numpy(),
                                  np.asarray(jstate.pose_wc.R))
    np.testing.assert_array_equal(port.pose_wc.t.numpy(),
                                  np.asarray(jstate.pose_wc.t))


@pytest.mark.parametrize("flags", [True, False])
def test_checkpoint_across_packages(tmp_path, flags):
    """A SemiDenseVOState checkpoint written by JAX's save_pytree loads
    into the port's with like= (NamedTuples back, bit-equal) and without
    (the same nested skeleton as JAX rebuilds); one written by the port
    loads into JAX's the same way.  ``flag_map=None`` is an empty subtree
    in both.  A template of another shape raises ValueError in both."""
    from tadataka_tpu.checkpoint import (
        save_pytree as jsave, load_pytree as jload)
    from tadataka_torch.checkpoint import save_pytree, load_pytree
    jstate, state = _states(flags=flags)

    jpath, path = tmp_path / "jax.npz", tmp_path / "port.npz"
    jsave(jpath, jstate)
    save_pytree(path, state)
    for a, b in ((jpath, path),):
        da, db = np.load(a), np.load(b)
        assert sorted(da.files) == sorted(db.files)
        for k in da.files:
            np.testing.assert_array_equal(da[k], db[k], err_msg=k)

    _assert_state_equal(load_pytree(jpath, like=state), jstate)
    back = jload(path, like=jstate)
    assert type(back) is JSemiDenseVOState
    for x, y in zip(np.asarray(back.depth_map), state.depth_map.numpy()):
        np.testing.assert_array_equal(x, y)
    if flags:
        np.testing.assert_array_equal(np.asarray(back.flag_map),
                                      state.flag_map.numpy())

    plain, jplain = load_pytree(jpath), jload(path)
    assert plain.keys() == jplain.keys()
    assert plain["pose_wc"].keys() == jplain["pose_wc"].keys() == {"R", "t"}
    np.testing.assert_array_equal(plain["depth_map"].numpy(),
                                  np.asarray(jplain["depth_map"]))

    bad_j, bad = _states(H=3, flags=flags)
    with pytest.raises(ValueError):
        load_pytree(jpath, like=bad)
    with pytest.raises(ValueError):
        jload(path, like=bad_j)


def test_checkpoint_roundtrip_devices_and_skeleton(tmp_path):
    """tests/test_aux.py's round trips on the port: template leaves keep
    their dtype; a plain int leaf comes back as an array; no template
    rebuilds dicts and lists; a shape mismatch raises."""
    from tadataka_torch.checkpoint import save_pytree, load_pytree
    tree = {"a": torch.arange(5.0), "b": {"c": torch.ones((3, 2)), "d": 7}}
    path = tmp_path / "state.npz"
    save_pytree(path, tree)
    like = {"a": torch.zeros(5, dtype=torch.float64),
            "b": {"c": torch.zeros((3, 2)), "d": 0}}
    loaded = load_pytree(path, like)
    assert loaded["a"].dtype == torch.float64
    assert torch.equal(loaded["a"], torch.arange(5.0, dtype=torch.float64))
    assert torch.equal(loaded["b"]["c"], torch.ones((3, 2)))
    assert int(loaded["b"]["d"]) == 7
    with pytest.raises(ValueError):
        load_pytree(path, {"a": torch.zeros(6),
                           "b": {"c": torch.zeros((3, 2)), "d": 0}})
    tree = {"depth": np.arange(6.0).reshape(2, 3),
            "meta": {"frames": [np.int32(3), np.int32(5)]},
            "pose": np.eye(4, dtype=np.float32)}
    save_pytree(path, tree)
    restored = load_pytree(path)
    np.testing.assert_array_equal(restored["depth"].numpy(), tree["depth"])
    assert [int(x) for x in restored["meta"]["frames"]] == [3, 5]


def test_save_trajectory_tum_matches(tmp_path):
    from tadataka_tpu.checkpoint import save_trajectory_tum as jsave
    from tadataka_torch.checkpoint import save_trajectory_tum
    gen = np.random.default_rng(2)
    poses = [Pose.from_rotvec(torch.from_numpy(gen.normal(0, 0.1, 3)
                                               .astype(np.float32)),
                              torch.from_numpy(gen.normal(size=3)
                                               .astype(np.float32)))
             for _ in range(3)]
    jposes = [JPose(jnp.asarray(p.R.numpy()), jnp.asarray(p.t.numpy()))
              for p in poses]
    save_trajectory_tum(tmp_path / "port.txt", [0.0, 0.1, 0.2], poses)
    jsave(tmp_path / "jax.txt", [0.0, 0.1, 0.2], jposes)
    assert (tmp_path / "port.txt").read_text() == \
        (tmp_path / "jax.txt").read_text()


def test_metrics_logger_and_flag_stats(tmp_path):
    """The same records (but the wall time) and summary as JAX's logger,
    and the same flag counts on one flag map."""
    from tadataka_tpu.flags import Flag as JFlag
    from tadataka_tpu.utils.observability import (
        MetricsLogger as JMetricsLogger, flag_stats as jflag_stats)
    from tadataka_torch.utils.observability import MetricsLogger, flag_stats
    gen = np.random.default_rng(5)
    flag_map = gen.integers(-len(JFlag) + 1, 1, (16, 12)).astype(np.int32)
    assert flag_stats(torch.from_numpy(flag_map)) == \
        jflag_stats(jnp.asarray(flag_map))
    logger, jlogger = MetricsLogger(tmp_path / "m.jsonl"), JMetricsLogger()
    for i, (fps, err) in enumerate(((10.0, 0.5), (20.0, 0.3))):
        rec = logger.log_frame(i, fps=fps, err=torch.tensor(err),
                               hist=torch.tensor([1, 2]), n=np.int64(3))
        jrec = jlogger.log_frame(i, fps=fps, err=jnp.float32(err),
                                 hist=jnp.asarray([1, 2]), n=np.int64(3))
        rec.pop("t_wall"), jrec.pop("t_wall")
        assert rec == jrec
    assert logger.summary() == jlogger.summary()
    lines = (tmp_path / "m.jsonl").read_text().splitlines()
    assert [json.loads(x)["fps"] for x in lines] == [10.0, 20.0]


def test_semi_dense_vo_logs_to_metrics_logger(tmp_path):
    """SemiDenseVO(metrics=MetricsLogger(...)) on a 3-frame 40x56 scene on
    the CPU: one record a frame past the first (which only starts the
    map), each with the planner's decision."""
    from tadataka_torch.apps.semi_dense_vo import SemiDenseVO
    from tadataka_torch.camera import CameraParameters
    from tadataka_torch.dataset import multi_plane_scene
    from tadataka_torch.utils.observability import MetricsLogger, flag_stats
    from tadataka_torch.vo.semi_dense import SemiDenseParams
    poses = [Pose.from_rotvec(torch.tensor([0.0, 0.002 * i, 0.0]),
                              torch.tensor([0.18 * i, 0.01 * i, 0.0]))
             for i in range(3)]
    ds = multi_plane_scene(3, (40, 56), (40.0, 40.0), poses)
    logger = MetricsLogger(tmp_path / "vo.jsonl")
    vo = SemiDenseVO(CameraParameters.create((40.0, 40.0), (28.0, 20.0)),
                     params=SemiDenseParams.create(2.0, 50.0,
                                                   ref_step_size=0.002,
                                                   min_gradient=0.01),
                     n_coarse_to_fine=3, history_size=3, metrics=logger,
                     device="cpu")
    vo.initial_pose_fn = lambda a, b: ds[1].pose.inv() * ds[0].pose
    for i in range(3):
        state = vo.estimate(ds[i])
    assert [r["frame"] for r in logger.records] == [1, 2]
    assert all(r["plan_path"] in ("tent", "rect", "scatter")
               for r in logger.records)
    assert len((tmp_path / "vo.jsonl").read_text().splitlines()) == 2
    assert "plan_n_planes" in logger.summary()
    assert sum(flag_stats(state.flag_map).values()) == 40 * 56


def test_profile_trace_writes_chrome_trace(tmp_path):
    from tadataka_torch.utils.observability import profile_trace, timed
    record = {}
    with profile_trace(tmp_path / "trace"):
        with timed(record, "matmul"):
            torch.ones(32, 32) @ torch.ones(32, 32)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]
    assert record["matmul"] >= 0.0


def test_optimization_framework_matches_jax(rng):
    """tests/test_aux.py's line fit with the same data through both
    frameworks: the port's theta within 1e-5 of JAX's (both solve the
    same least-squares steps in float32) and within 0.05 of the truth;
    the robustifier gradients and weights within rtol 1e-6 / atol 1e-7 of
    JAX's (at x=10 the Geman-McClure derivative's two terms cancel, u/v =
    100, so the two AD systems' roundings part by ~1e-5 of its 2e-3:
    2e-8 measured)."""
    from tadataka_tpu.optimization import (
        BaseResidual as JBaseResidual, Function as JFunction,
        GaussNewtonUpdater as JGaussNewtonUpdater,
        GemanMcClureRobustifier as JGemanMcClure, Optimizer as JOptimizer,
        SquaredRobustifier as JSquared,
        SumRobustifiedNormError as JSumError)
    from tadataka_torch.optimization import (
        BaseResidual, Function, GaussNewtonUpdater, GemanMcClureRobustifier,
        Optimizer, SquaredRobustifier, SumRobustifiedNormError)

    X = rng.uniform(-1, 1, (50, 1)).astype(np.float32)
    theta_true = np.array([2.0, -1.0], np.float32)
    y = theta_true[0] * X[:, 0] + theta_true[1]
    y = (y + rng.normal(0, 0.01, y.shape)).astype(np.float32)

    class LineModel(Function):
        def compute(self, theta):
            return theta[0] * torch.from_numpy(X[:, 0]) + theta[1]

    class JLineModel(JFunction):
        def compute(self, theta):
            return theta[0] * jnp.asarray(X[:, 0]) + theta[1]

    residual = BaseResidual(torch.from_numpy(y), LineModel())
    theta = Optimizer(GaussNewtonUpdater(residual, SquaredRobustifier()),
                      residual,
                      SumRobustifiedNormError(SquaredRobustifier())).optimize(
        torch.zeros(2), max_iter=50)
    jresidual = JBaseResidual(jnp.asarray(y), JLineModel())
    jtheta = JOptimizer(JGaussNewtonUpdater(jresidual, JSquared()),
                        jresidual, JSumError(JSquared())).optimize(
        jnp.zeros(2), max_iter=50)
    np.testing.assert_allclose(theta.numpy(), np.asarray(jtheta), atol=1e-5)
    np.testing.assert_allclose(theta.numpy(), theta_true, atol=0.05)

    x = np.array([0.0, 0.1, -0.7, 10.0], np.float32)
    for port, ref in ((GemanMcClureRobustifier(1.0), JGemanMcClure(1.0)),
                      (SquaredRobustifier(), JSquared())):
        np.testing.assert_allclose(port.grad(torch.from_numpy(x)).numpy(),
                                   np.asarray(ref.grad(jnp.asarray(x))),
                                   rtol=1e-6, atol=1e-7)
        w = port.weights(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(w, np.asarray(ref.weights(jnp.asarray(x))),
                                   rtol=1e-6, atol=1e-7)
        assert w[0] == 0.0
    r = rng.normal(size=(7, 2)).astype(np.float32)
    np.testing.assert_allclose(
        float(SumRobustifiedNormError(GemanMcClureRobustifier(0.5)).compute(
            torch.from_numpy(r))),
        float(JSumError(JGemanMcClure(0.5)).compute(jnp.asarray(r))),
        rtol=1e-6)


def test_array_utils_match(rng):
    """Every helper gives JAX's module's values on the same inputs and
    draws."""
    from tadataka_tpu.utils import arrays as jarrays
    from tadataka_torch.utils import arrays
    assert list(arrays.indices_other_than(8, [1, 2, 3])) == [0, 4, 5, 6, 7]
    assert arrays.merge_dicts({"a": 1}, {"b": 2}) == {"a": 1, "b": 2}
    assert arrays.value_list({"a": 1, "b": 2}, ["b", "a"]) == [2, 1]
    np.testing.assert_array_equal(arrays.round_int([0.4, 1.6, -2.5]),
                                  jarrays.round_int([0.4, 1.6, -2.5]))
    assert arrays.radian_to_degree(np.pi) == jarrays.radian_to_degree(np.pi)
    desc = np.where(rng.integers(0, 2, (10, 32)), 1.0, -1.0).astype(
        np.float32)
    for fn in ("add_noise", "break_other_than"):
        a = getattr(arrays, fn)(desc, [0, 1], rng=np.random.default_rng(0))
        b = getattr(jarrays, fn)(desc, [0, 1], rng=np.random.default_rng(0))
        np.testing.assert_array_equal(a, b)
    bits = desc > 0
    np.testing.assert_array_equal(
        arrays.add_noise(bits, [2], rng=np.random.default_rng(1)),
        jarrays.add_noise(bits, [2], rng=np.random.default_rng(1)))


def test_native_loader_matches_jax(tmp_path, rng):
    """PNGs written by the port's codec (gray8, rgb8, rgba8, gray16):
    the port's native decoder and prefetcher give JAX's native_loader's
    arrays; built under build/, never in native/."""
    from tadataka_tpu.dataset import native_loader as jnative
    from tadataka_torch.dataset import native_loader
    from tadataka_torch.dataset.image_io import imsave
    specs = [((24, 32), np.uint8), ((16, 20, 3), np.uint8),
             ((10, 14, 4), np.uint8), ((12, 18), np.uint16)]
    paths, arrays = [], []
    for i, (shape, dtype) in enumerate(specs):
        arr = (rng.integers(0, 255, shape, dtype=np.uint8)
               if dtype == np.uint8
               else rng.integers(0, 60000, shape).astype(np.uint16))
        paths.append(tmp_path / f"img_{i}.png")
        imsave(paths[-1], arr)
        arrays.append(arr)
    assert native_loader.native_available()
    assert native_loader.BUILD_DIR.parts[-3:] == (
        "build", "tadataka_torch", "native")
    for path, arr in zip(paths, arrays):
        got = native_loader.imread_native(path)
        np.testing.assert_array_equal(got, arr)
        if jnative.native_available():
            np.testing.assert_array_equal(got, jnative.imread_native(path))
    loader = native_loader.PrefetchingLoader(paths, n_threads=2,
                                             capacity=2)
    for got, arr in zip(loader, arrays):
        np.testing.assert_array_equal(got, arr)
    with pytest.raises(IndexError):
        loader[0]
    loader.close()


def test_native_loader_without_toolchain(tmp_path, monkeypatch, rng):
    """No native library: both readers decode through image_io.imread and
    native_available() says so."""
    from tadataka_torch.dataset import native_loader
    from tadataka_torch.dataset.image_io import imsave
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_failed", RuntimeError("no g++"))
    arr = rng.integers(0, 255, (9, 7), dtype=np.uint8)
    imsave(tmp_path / "a.png", arr)
    assert not native_loader.native_available()
    np.testing.assert_array_equal(
        native_loader.imread_native(tmp_path / "a.png"), arr)
    loader = native_loader.PrefetchingLoader([tmp_path / "a.png"])
    np.testing.assert_array_equal(loader[0], arr)


def test_viz_headless(rng):
    """Every plot under Agg, from tensors and numpy arrays."""
    import matplotlib.pyplot as plt
    from tadataka_torch.viz import (
        plot_map, plot_trajectory, plot_matches, plot_depth_dashboard)
    points = torch.from_numpy(rng.uniform(-1, 1, (50, 3)))
    poses = [Pose.identity(),
             Pose.from_rotvec(torch.zeros(3), torch.tensor([1.0, 0, 0]))]
    assert plot_map(poses, points, show=False) is not None
    assert plot_trajectory(rng.uniform(0, 1, (5, 3)),
                           torch.from_numpy(rng.uniform(0, 1, (5, 3))),
                           show=False) is not None
    img = torch.from_numpy(rng.uniform(0, 1, (20, 30)))
    kp = rng.uniform(0, 19, (8, 2))
    matches = np.stack([np.arange(8), np.arange(8)], axis=1)
    assert plot_matches(img, img, kp, kp, matches, show=False) is not None
    assert plot_depth_dashboard(img, img, img,
                                torch.zeros((20, 30), dtype=torch.int32),
                                show=False) is not None
    plt.close("all")


def test_animation_viewers_headless():
    """The three viewers step through the port's DvoTrajectory on a
    3-frame plane scene (CPU) and a stub feature VO."""
    import matplotlib.pyplot as plt
    from tadataka_torch.apps.dvo_trajectory import DvoTrajectory
    from tadataka_torch.dataset.synthetic import PlaneSceneDataset
    from tadataka_torch.viz import (
        FeatureVOAnimation, TrajectoryOrbitAnimation, VOAnimation)
    poses = [Pose.from_rotvec(torch.zeros(3),
                              torch.tensor([0.05 * i, 0.0, 0.0]))
             for i in range(3)]
    ds = PlaneSceneDataset(len(poses), image_shape=(48, 64), poses=poses,
                           focal_length=(48.0, 48.0))
    est = DvoTrajectory(ds.camera_model, n_coarse_to_fine=2, max_iter=3,
                        device="cpu")
    anim = VOAnimation(est, ds)
    for i in range(3):
        anim.update(i)
    assert anim.trajectory_pred.shape == (3, 3)
    assert anim.animate() is not None
    orbit = TrajectoryOrbitAnimation(anim.trajectory_true,
                                     anim.trajectory_pred)
    orbit.update(45)
    assert orbit.animate(frames=4) is not None

    class _StubVO:
        def __init__(self):
            self.n = 0

        def estimate(self, frame):
            self.n += 1
            return Pose.from_rotvec(torch.zeros(3),
                                    torch.tensor([0.1 * self.n, 0.0, 0.0]))

        def export_points(self):
            return torch.ones((5, 3)) * self.n

    fanim = FeatureVOAnimation(_StubVO(), ds)
    for i in range(3):
        fanim.update(i)
    assert fanim.trajectory.shape == (3, 3)
    plt.close("all")


def test_modules_import_without_jax_or_matplotlib():
    """The slice's modules import with jax, the JAX package and
    matplotlib unimportable (the card's machine has no matplotlib; viz
    imports it inside its functions), and a checkpoint round trip and
    the CPU mesh run there."""
    import os
    import subprocess
    import sys
    import textwrap
    from pathlib import Path
    script = textwrap.dedent("""
        import sys, tempfile
        for name in ("jax", "tadataka_tpu", "matplotlib"):
            sys.modules[name] = None
        import torch
        import tadataka_torch.checkpoint as checkpoint
        import tadataka_torch.config
        import tadataka_torch.dataset.native_loader
        import tadataka_torch.optimization
        import tadataka_torch.parallel
        import tadataka_torch.utils.arrays
        import tadataka_torch.utils.observability
        import tadataka_torch.viz
        from tadataka_torch.parallel.mesh import make_mesh, psum
        mesh = make_mesh(["cpu"] * 3)
        assert torch.equal(psum(mesh, [torch.ones(2)] * 3)[0],
                           torch.full((2,), 3.0))
        with tempfile.TemporaryDirectory() as d:
            checkpoint.save_pytree(d + "/s.npz", {"a": [torch.ones(2)]})
            assert torch.equal(checkpoint.load_pytree(d + "/s.npz")["a"][0],
                               torch.ones(2))
    """)
    env = dict(os.environ,
               PYTHONPATH=str(Path(__file__).resolve().parents[1]))
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
