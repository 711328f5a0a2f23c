"""The port's demo entry points (``tadataka_torch/examples/``) against the
JAX package's (``examples/*.py``), on the CPU.

Each port example's ``main([..., "--device", "cpu"])`` runs beside the
JAX example's ``main`` on the same flags (the JAX scripts are loaded by
path with ``importlib``, unedited, and read ``sys.argv``), and the
records each prints are compared at the tolerance each test states.
Where the JAX example is too dear to run here, the port's example is
held to the library run it makes, which the named parity test holds to
the JAX package:

- ``feature_based_vo``: ``FeatureBasedVO`` on the same frames and
  settings (``tests/test_torch_feature_vo.py``, the same sequence);
- ``vitamin_e_vo``: ``VitaminEVO`` on the same frames
  (``tests/test_torch_vitamin_e.py::test_vitamin_e_vo``);
- ``semi_dense_vo --tum``: the TUM loader (``tests/test_torch_dvo_app.py``)
  and ``SemiDenseVO`` (``tests/test_torch_app.py``); the two packages'
  random initial maps differ, so past frame 0 the records would not.

The NewTsukuba fixture that ``dense_triangulation`` and
``semi_dense_vo --tsukuba`` read is not in this repository: both
packages' code runs on a stand-in dataset of synthetic frames instead.
"""

import ast
import importlib
import importlib.util
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
NAMES = ("semi_dense_vo", "dvo_trajectory", "feature_based_vo",
         "depth_from_stereo", "vitamin_e", "vitamin_e_vo",
         "dense_triangulation")
NUMBER = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")


def jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def port_example(name):
    return importlib.import_module(f"tadataka_torch.examples.{name}")


def run_jax(name, argv, monkeypatch, capsys, module=None):
    module = module or jax_example(name)
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + argv)
    capsys.readouterr()
    module.main()
    return capsys.readouterr().out.splitlines()


def run_port(name, argv, capsys, module=None):
    module = module or port_example(name)
    capsys.readouterr()
    module.main(argv + ["--device", "cpu"])
    return capsys.readouterr().out.splitlines()


def numbers(line):
    return [float(x) for x in NUMBER.findall(line)]


def template(line):
    return NUMBER.sub("#", line)


def assert_lines_close(port, ref, atol):
    """The same lines but for their numbers, each within ``atol``."""
    assert [template(x) for x in port] == [template(x) for x in ref], (
        port, ref)
    for a, b in zip(port, ref):
        np.testing.assert_allclose(numbers(a), numbers(b), rtol=0,
                                   atol=atol, err_msg=f"{a!r} / {b!r}")


@pytest.mark.parametrize("name", NAMES)
def test_example_defaults_to_the_card(name):
    """Each example takes ``--device``, the card by default, and raises
    without one (no CPU fallback)."""
    module = port_example(name)
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([])


def test_dvo_trajectory_matches_jax(monkeypatch, capsys):
    """Positions (printed to 4 decimals) within 1e-4, the ATE within
    1e-5."""
    argv = ["--frames", "3"]
    ref = run_jax("dvo_trajectory", argv, monkeypatch, capsys)
    port = run_port("dvo_trajectory", argv, capsys)
    assert len(port) == 2
    assert_lines_close(port[:1], ref[:1], atol=1.01e-4)
    assert_lines_close(port[1:], ref[1:], atol=1.01e-5)


def test_depth_from_stereo_matches_jax(monkeypatch, capsys):
    """The scattered estimator's flag histogram within 20 of 19200
    pixels a flag, the SUCCESS share within 0.002, the median depth error
    on SUCCESS pixels within 1e-3 (``tests/test_torch_estimator.py``
    holds the estimator per pixel)."""
    ref = run_jax("depth_from_stereo", [], monkeypatch, capsys)
    port = run_port("depth_from_stereo", [], capsys)
    assert [template(x) for x in port[1:]] == [template(x) for x in ref[1:]]
    hist = [ast.literal_eval(x.split(": ", 1)[1]) for x in (port[0], ref[0])]
    for flag in set(hist[0]) | set(hist[1]):
        assert abs(hist[0].get(flag, 0) - hist[1].get(flag, 0)) <= 20, hist
    np.testing.assert_allclose(numbers(port[1]), numbers(ref[1]), atol=2e-3)
    np.testing.assert_allclose(numbers(port[2]), numbers(ref[2]), atol=1e-3)


def test_vitamin_e_matches_jax(monkeypatch, capsys):
    """The tracks of each frame and the triangulated count: equal."""
    argv = ["--frames", "2"]
    ref = run_jax("vitamin_e", argv, monkeypatch, capsys)
    port = run_port("vitamin_e", argv, capsys)
    assert port == ref and len(port) == 3


def records(lines):
    """The MetricsLogger records a semi_dense_vo run prints, without the
    wall clock, and its summary."""
    recs = [ast.literal_eval(x) for x in lines if x.startswith("{")]
    for r in recs:
        r.pop("t_wall")
    summary = [ast.literal_eval(x.split(": ", 1)[1]) for x in lines
               if x.startswith("summary:")]
    return recs, summary[0]


def test_semi_dense_vo_matches_jax(monkeypatch, capsys):
    """The synthetic path over 2 frames (the bootstrap with the true
    pose): the same records, positions within 1e-6, SUCCESS share and
    median depth error within 5e-3."""
    argv = ["--frames", "2"]
    ref, ref_summary = records(run_jax("semi_dense_vo", argv, monkeypatch,
                                       capsys))
    port, port_summary = records(run_port("semi_dense_vo", argv, capsys))
    assert [sorted(r) for r in port] == [sorted(r) for r in ref]
    assert len(port) == 2 and "median_depth_err" in port[1]
    for p, r in zip(port, ref):
        assert p["frame"] == r["frame"]
        np.testing.assert_allclose(p["t"], r["t"], atol=1e-6)
        for key in ("success_frac", "median_depth_err"):
            if key in r:
                assert abs(p[key] - r[key]) < 5e-3, (key, p, r)
    assert sorted(port_summary) == sorted(ref_summary)
    for key, value in ref_summary.items():
        assert abs(port_summary[key] - value) < 5e-3, (key, port_summary)


def test_semi_dense_vo_tum(tmp_path, capsys):
    """``--tum`` on a freiburg1 tree that ``export_tum_scene`` writes:
    every third frame, a finite position and a SUCCESS share a record,
    frame 0 at the origin."""
    from tadataka_torch.dataset import export_tum_scene
    export_tum_scene(tmp_path, n_frames=4, image_shape=(60, 80))
    port, summary = records(run_port(
        "semi_dense_vo", ["--tum", str(tmp_path), "--freiburg", "1",
                          "--frames", "2"], capsys))
    assert [r["frame"] for r in port] == [0, 1]
    assert port[0]["t"] == [0.0, 0.0, 0.0]
    assert np.isfinite(port[1]["t"]).all()
    assert 0.0 <= port[1]["success_frac"] <= 1.0
    assert summary["success_frac"] == port[1]["success_frac"]


def recording(cls, after=lambda vo: None):
    """A subclass of the VO class ``cls`` that keeps its constructor's
    keyword arguments, and each pose its ``estimate`` returns with
    ``after(vo)`` read just after."""
    class Recording(cls):
        made = []

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.recorded_kwargs, self.recorded = kwargs, []
            Recording.made.append(self)

        def estimate(self, frame):
            pose = super().estimate(frame)
            self.recorded.append((pose, after(self)))
            return pose
    return Recording


def test_feature_based_vo_example_is_the_library(monkeypatch, capsys):
    """The example runs ``FeatureBasedVO`` with the settings of
    tests/vo/test_feature_based.py on its trajectory at 120x160 (the
    library run that tests/test_torch_feature_vo.py holds to the JAX
    package) and prints what it returns: each position rounded to 3
    decimals, the aligned ATE, the map's size."""
    from tadataka_torch.metrics import absolute_trajectory_error
    module = port_example("feature_based_vo")
    vo_class = recording(module.FeatureBasedVO)
    monkeypatch.setattr(module, "FeatureBasedVO", vo_class)
    lines = run_port("feature_based_vo", ["--frames", "3"], capsys, module)
    (vo,) = vo_class.made
    assert vo.recorded_kwargs == dict(
        window_size=8, min_matches=12, max_keypoints=512, patch_size=24,
        fast_threshold=0.02, device=torch.device("cpu"))
    poses = [pose for pose, _ in vo.recorded]
    assert len(poses) == 3 and all(p is not None for p in poses)
    est = np.stack([p.t.numpy() for p in poses])
    gt = np.array([[0.25 * i, 0.01 * i, 0.02 * i] for i in range(3)],
                  np.float32)
    assert lines == [f"frame {i}: t = {est[i].round(3)}" for i in range(3)] + [
        f"ATE (sim3-aligned): "
        f"{float(absolute_trajectory_error(est, gt)):.4f}",
        f"map: {len(vo.export_points()[0])} points"]


def test_vitamin_e_vo_example_is_the_library(monkeypatch, capsys,
                                             tmp_path):
    """Where the fixture is absent, the example runs
    ``VitaminEVO(fast_threshold=0.02, lambda_=0.5)`` on the synthetic
    scene, the run that
    tests/test_torch_vitamin_e.py::test_vitamin_e_vo holds to the JAX
    package, and prints each frame's position (3 decimals), tracks and
    map size, and the aligned ATE."""
    module = port_example("vitamin_e_vo")
    vo_class = recording(module.VitaminEVO, after=lambda vo: (
        len(vo.keypoints[-1].ids), len(vo.points)))
    monkeypatch.setattr(module, "VitaminEVO", vo_class)
    monkeypatch.setattr(module, "NEW_TSUKUBA_FIXTURE", tmp_path / "absent")
    lines = run_port("vitamin_e_vo", ["--frames", "3"], capsys, module)
    (vo,) = vo_class.made
    assert vo.recorded_kwargs == dict(fast_threshold=0.02, lambda_=0.5,
                                      device=torch.device("cpu"))
    assert len(vo.recorded) == 3
    assert lines[:3] == [
        f"frame {i}: pose {np.round(pose.t.numpy(), 3)}  tracks {tracks}  "
        f"map {points}"
        for i, (pose, (tracks, points)) in enumerate(vo.recorded)]
    assert lines[3].startswith("ATE after Umeyama alignment: ")


class _StandIn:
    """A NewTsukuba-shaped dataset (``ds[i]`` a (left, right) pair,
    ``camera_model``) of 5 synthetic frames: the multi-plane scene at
    ``shape`` and ``focal`` with the EuRoC
    export's texture, camera -> world poses ``step`` m apart a frame.
    ``package``: "jax" or "torch" types."""

    def __init__(self, package, shape, focal, step):
        from tadataka_torch.core.pose import Pose
        from tadataka_torch.dataset.synthetic import (
            MULTI_PLANES, PlaneSceneDataset, _sharp_texture)
        n = 5
        poses = [Pose.from_rotvec(torch.tensor([0.0, 0.003 * i, 0.0]),
                                  torch.tensor([step * i, 0.01 * i, 0.0]))
                 for i in range(n)]
        ds = PlaneSceneDataset(n, shape, (focal, focal), poses=poses,
                               planes=MULTI_PLANES, texture=_sharp_texture)
        frames = [ds[i] for i in range(n)]
        self.camera_model = frames[0].camera_model
        if package == "jax":
            import jax.numpy as jnp
            from tadataka_tpu.camera import CameraModel, CameraParameters
            from tadataka_tpu.core.pose import Pose as JPose
            from tadataka_tpu.dataset.frame import Frame as JFrame
            self.camera_model = CameraModel.create(CameraParameters.create(
                (focal, focal), (shape[1] / 2.0, shape[0] / 2.0)))
            frames = [JFrame(self.camera_model,
                             JPose(jnp.asarray(f.pose.R.numpy()),
                                   jnp.asarray(f.pose.t.numpy())),
                             f.image.numpy(), f.depth_map.numpy())
                      for f in frames]
        self.frames = frames

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i):
        return self.frames[i], self.frames[i]


SMALL = ((120, 160), 120.0, 0.15)
WIDE = ((240, 320), 240.0, 0.5)


def test_dense_triangulation_on_stand_in(monkeypatch, capsys):
    """Both examples' whole ``main`` (sparse, dense-match and dense-track
    triangulation of frames 0 and 4) on a stand-in dataset at 120x160,
    focal 120, 0.15 m a frame: the same
    three report lines, point counts within 2% and median distances
    within 1%."""
    jmodule = jax_example("dense_triangulation")
    monkeypatch.setattr(jmodule, "NewTsukubaDataset",
                        lambda root: _StandIn("jax", *SMALL))
    ref = run_jax("dense_triangulation", [], monkeypatch, capsys, jmodule)
    monkeypatch.setattr("tadataka_torch.dataset.new_tsukuba."
                        "NewTsukubaDataset",
                        lambda root: _StandIn("torch", *SMALL))
    port = run_port("dense_triangulation", [], capsys)
    assert [template(x) for x in port] == [template(x) for x in ref]
    assert len(port) == 3
    for a, b in zip(port, ref):
        (na, da), (nb, db) = numbers(a)[-2:], numbers(b)[-2:]
        assert nb > 50 and abs(na - nb) <= 0.02 * nb, (a, b)
        assert abs(da - db) <= 0.01 * db, (a, b)


def _angle(R):
    return float(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)))


def _cos(a, b):
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_semi_dense_vo_tsukuba_bootstrap_on_stand_in(monkeypatch):
    """``--tsukuba``'s frames and its essential-matrix bootstrap on the
    stand-in dataset at 240x320, focal 240, 0.5 m a frame (where both
    packages' essential bootstraps find the motion, 0.9999 in cosine;
    at 120x160 and 0.15 m neither does).  The RANSAC draws differ, so the
    port's bootstrap pose of frames 0 and 1 is held to JAX's error
    against the truth: its rotation error within JAX's + 0.002 rad, its
    translation's direction within JAX's cosine - 0.001, and its length
    the true first step (the example's scale) in both, within 1e-5."""
    import jax.numpy as jnp
    jmodule = jax_example("semi_dense_vo")
    monkeypatch.setattr("tadataka_tpu.dataset.new_tsukuba."
                        "NewTsukubaDataset",
                        lambda root: _StandIn("jax", *WIDE))
    monkeypatch.setattr("tadataka_torch.dataset.new_tsukuba."
                        "NewTsukubaDataset",
                        lambda root: _StandIn("torch", *WIDE))
    jvo, jframes = jmodule.tsukuba_frames(3)
    vo, frames = port_example("semi_dense_vo").tsukuba_frames(3, "cpu")
    assert len(frames) == len(jframes) == 3
    images = [f.image for f in frames]
    jpose = jvo.initial_pose_fn(jnp.asarray(images[0].numpy()),
                                jnp.asarray(images[1].numpy()))
    pose = vo.initial_pose_fn(images[0], images[1])
    true = frames[1].pose.inv() * frames[0].pose
    R_true, t_true = true.R.numpy(), true.t.numpy()
    errors = [_angle(np.asarray(R).T @ R_true)
              for R in (pose.R.numpy(), jpose.R)]
    assert errors[0] < errors[1] + 2e-3, errors
    t, jt = pose.t.numpy(), np.asarray(jpose.t)
    assert _cos(t, t_true) > _cos(jt, t_true) - 1e-3, (t, jt, t_true)
    step = float(np.linalg.norm(t_true))
    np.testing.assert_allclose([np.linalg.norm(t), np.linalg.norm(jt)],
                               step, rtol=1e-5)
