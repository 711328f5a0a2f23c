"""Parity of the port's dataset loaders and camera IO with the JAX
package's, on the CPU.

The on-disk trees of tests/dataset/test_datasets.py (TUM RGB-D,
NewTsukuba with XML depth and RGBA PNGs, EuRoC, collaborative) are built
twice from the same seeds: once with the JAX package's PNG writer for
its loader and once with the port's codec for the port's, so that each
NewTsukuba loader writes its own ``.npy`` cache.  Also: the port's
reader of EuRoC's YAML subset against ``yaml.safe_load``, the EuRoC
exporter file by file, the camera file round trip, the normalization
lookup table, and the point-cloud scenes.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from scipy.spatial.transform import Rotation

from tadataka_tpu.camera import CameraModel as JCameraModel
from tadataka_tpu.camera import NormalizationMapTable as JTable
from tadataka_tpu.camera import load as jload_cameras
from tadataka_tpu.camera import save as jsave_cameras
from tadataka_tpu.dataset import EurocDataset as JEurocDataset
from tadataka_tpu.dataset import NewTsukubaDataset as JNewTsukubaDataset
from tadataka_tpu.dataset import TumRgbdDataset as JTumRgbdDataset
from tadataka_tpu.dataset import image_io as jimage_io
from tadataka_tpu.dataset import points as jpoints
from tadataka_tpu.dataset.collaborative import (
    CollaborativeDataset as JCollaborativeDataset)
from tadataka_tpu.dataset.synthetic import (
    export_euroc_scene as jexport_euroc_scene)

from tadataka_torch.camera import CameraModel, NormalizationMapTable
from tadataka_torch.camera import load as load_cameras
from tadataka_torch.camera import save as save_cameras
from tadataka_torch.dataset import (
    EurocDataset, NewTsukubaDataset, TumRgbdDataset, export_euroc_scene,
    image_io, points, sensor_yaml)
from tadataka_torch.dataset.collaborative import CollaborativeDataset
from tadataka_torch.dataset.image_io import imread

WRITERS = {"jax": jimage_io.imsave, "port": image_io.imsave}


def write_tum(root, imsave):
    """tests/dataset/test_datasets.py's TUM tree."""
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    rng = np.random.default_rng(0)
    rgb_lines, depth_lines, gt_lines = (["# color images"],
                                        ["# depth images"],
                                        ["# ground truth"])
    for i in range(4):
        t = 100.0 + i * 0.1
        imsave(root / "rgb" / f"{t:.4f}.png",
               rng.integers(0, 255, (12, 16, 3), dtype=np.uint8))
        imsave(root / "depth" / f"{t + 0.01:.4f}.png",
               rng.integers(1000, 30000, (12, 16)).astype(np.uint16))
        rgb_lines.append(f"{t:.4f} rgb/{t:.4f}.png")
        depth_lines.append(f"{t + 0.01:.4f} depth/{t + 0.01:.4f}.png")
        q = Rotation.from_rotvec([0, 0.01 * i, 0]).as_quat()
        gt_lines.append(f"{t + 0.005:.4f} {0.1*i} 0 0 "
                        f"{q[0]} {q[1]} {q[2]} {q[3]}")
    for name, lines in (("rgb", rgb_lines), ("depth", depth_lines),
                        ("groundtruth", gt_lines)):
        (root / f"{name}.txt").write_text("\n".join(lines) + "\n")


def write_tsukuba(root, imsave):
    """tests/dataset/test_datasets.py's NewTsukuba tree: XML depth and
    RGBA images."""
    gt = root / "groundtruth"
    ill = root / "illumination" / "daylight"
    for d in (gt / "depth_maps" / "left", gt / "depth_maps" / "right",
              ill / "left", ill / "right"):
        d.mkdir(parents=True)
    rng = np.random.default_rng(1)
    track = []
    for i in range(3):
        for side in ("left", "right"):
            depth = rng.uniform(50, 300, (10, 14))
            rows = "\n".join(" ".join(f"{v:.3f}" for v in row)
                             for row in depth)
            (gt / "depth_maps" / side / f"frame_{i:05d}.xml").write_text(
                "<opencv_storage><depth type_id=\"opencv-matrix\">"
                "<rows>10</rows><cols>14</cols><dt>f</dt>"
                f"<data>{rows}</data></depth></opencv_storage>")
            imsave(ill / side / f"frame_{i:05d}.png",
                   rng.integers(0, 255, (10, 14, 4), dtype=np.uint8))
        track.append(f"{i*1.0},0,0,0,{i*2.0},0")
    (gt / "camera_track.txt").write_text("\n".join(track))


def write_euroc(root, imsave):
    """tests/dataset/test_datasets.py's EuRoC tree."""
    rng = np.random.default_rng(2)
    for ci in range(2):
        cam = root / f"cam{ci}"
        (cam / "data").mkdir(parents=True)
        lines = ["#timestamp [ns],filename"]
        for i in range(3):
            ts = 1000000 + i * 50000
            imsave(cam / "data" / f"{ts}.png",
                   rng.integers(0, 255, (8, 10), dtype=np.uint8))
            lines.append(f"{ts},{ts}.png")
        (cam / "data.csv").write_text("\n".join(lines))
        T = np.eye(4)
        T[0, 3] = 0.1 * ci
        (cam / "sensor.yaml").write_text(
            "intrinsics: [458.0, 457.0, 367.0, 248.0]\n"
            "distortion_coefficients: [-0.28, 0.07, 0.0002, 0.00002]\n"
            "T_BS:\n  data: [" + ", ".join(str(v) for v in T.ravel())
            + "]\n")
    gtdir = root / "state_groundtruth_estimate0"
    gtdir.mkdir()
    lines = ["#timestamp,px,py,pz,qw,qx,qy,qz"]
    for i in range(3):
        lines.append(f"{1000000 + i * 50000 + 100},{0.2*i},0,0,1,0,0,0")
    (gtdir / "data.csv").write_text("\n".join(lines))


def write_collaborative(root, imsave):
    """tests/dataset/test_datasets.py's collaborative tree (with its
    unpaired file)."""
    root.mkdir(parents=True)
    rng = np.random.default_rng(3939)
    for ts in (100, 200, 300):
        imsave(root / f"frame-{ts}.color.png",
               rng.integers(0, 255, (8, 10, 3), dtype=np.uint8))
        imsave(root / f"frame-{ts}.depth.png",
               rng.integers(500, 5000, (8, 10)).astype(np.uint16))
    imsave(root / "frame-400.color.png",
           rng.integers(0, 255, (8, 10, 3), dtype=np.uint8))


def trees(tmp_path, write):
    """The tree written once per package: {"jax": root, "port": root}."""
    roots = {}
    for name, imsave in WRITERS.items():
        roots[name] = tmp_path / name
        write(roots[name], imsave)
    return roots


def as_np(x):
    return None if x is None else np.asarray(x)


def assert_frames_match(jframe, frame):
    """Images and depth equal, poses within atol 1e-6."""
    np.testing.assert_array_equal(frame.image.numpy(), as_np(jframe.image))
    if jframe.depth_map is None:
        assert frame.depth_map is None
    else:
        np.testing.assert_array_equal(frame.depth_map.numpy(),
                                      as_np(jframe.depth_map))
    if jframe.pose is not None:
        np.testing.assert_allclose(frame.pose.R.numpy(),
                                   as_np(jframe.pose.R), atol=1e-6)
        np.testing.assert_allclose(frame.pose.t.numpy(),
                                   as_np(jframe.pose.t), atol=1e-6)


def test_tum_rgbd_trees(tmp_path):
    roots = trees(tmp_path, write_tum)
    jds = JTumRgbdDataset(str(roots["jax"]), which_freiburg=1)
    ds = TumRgbdDataset(str(roots["port"]), which_freiburg=1)
    assert len(ds) == len(jds) == 4
    for i in range(4):
        assert_frames_match(jds[i], ds[i])


def test_new_tsukuba_trees(tmp_path):
    """Each loader writes its own depth and image caches next to its tree;
    frames (RGBA read, alpha dropped) equal, stereo baseline 10."""
    roots = trees(tmp_path, write_tsukuba)
    jds = JNewTsukubaDataset(str(roots["jax"]))
    ds = NewTsukubaDataset(str(roots["port"]))
    for root in roots.values():
        assert (root / "groundtruth" / "depth_cache" / "left").is_dir()
        assert (root / "illumination" / "daylight_cache" / "right").is_dir()
    assert len(ds) == len(jds) == 3
    for i in range(3):
        for jframe, frame in zip(jds[i], ds[i]):
            assert_frames_match(jframe, frame)
    left, right = ds[1]
    assert left.image.shape == (10, 14, 3)
    assert np.isclose(float(torch.linalg.norm(right.pose.t - left.pose.t)),
                      10.0, atol=1e-4)
    # a second load reads the caches
    again = NewTsukubaDataset(str(roots["port"]))
    assert_frames_match(ds[2][0], again[2][0])


def test_euroc_trees(tmp_path):
    roots = trees(tmp_path, write_euroc)
    jds = JEurocDataset(str(roots["jax"]))
    ds = EurocDataset(str(roots["port"]))
    assert len(ds) == len(jds) == 3
    for i in range(3):
        for jframe, frame in zip(jds[i], ds[i]):
            assert_frames_match(jframe, frame)
    f0, f1 = ds[0]
    np.testing.assert_allclose((f1.pose.t - f0.pose.t).numpy(), [0.1, 0, 0],
                               atol=1e-6)
    np.testing.assert_array_equal(
        f0.camera_model.distortion_model.dist_coeffs.numpy(),
        np.asarray(jds[0][0].camera_model.distortion_model.dist_coeffs))


def test_collaborative_trees(tmp_path):
    roots = trees(tmp_path, write_collaborative)
    jds = JCollaborativeDataset(str(roots["jax"]), depth_factor=1000.0)
    ds = CollaborativeDataset(str(roots["port"]), depth_factor=1000.0)
    assert len(ds) == len(jds) == 3
    assert ds.timestamps == jds.timestamps
    for i in range(3):
        assert_frames_match(jds[i], ds[i])


EUROC_LAYOUT = """# General sensor definitions.
sensor_type: camera
comment: VI-Sensor cam0 (MT9M034)

# Sensor extrinsics wrt. the body-frame.
T_BS:
  cols: 4
  rows: 4
  data: [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975,
         0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768,
        -0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949,
         0.0, 0.0, 0.0, 1.0]

# Camera specific definitions.
rate_hz: 20
resolution: [752, 480]
camera_model: pinhole
intrinsics: [458.654, 457.296, 367.215, 248.375] #fu, fv, cu, cv
distortion_model: radial-tangential
distortion_coefficients: [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]
"""


def test_sensor_yaml_matches_safe_load(tmp_path):
    """The port's reader gives what ``yaml.safe_load`` gives on a text in
    EuRoC's own layout (comments, a ``data:`` list over several lines)
    and on the exporter's (whose ``5e-05`` YAML 1.1 keeps a string)."""
    assert sensor_yaml.loads(EUROC_LAYOUT) == yaml.safe_load(EUROC_LAYOUT)
    export_euroc_scene(tmp_path, n_frames=1, image_shape=(8, 12))
    text = (tmp_path / "cam1" / "sensor.yaml").read_text()
    parsed = sensor_yaml.load(tmp_path / "cam1" / "sensor.yaml")
    assert parsed == yaml.safe_load(text)
    assert parsed["distortion_coefficients"][2:] == ["5e-05", "1e-05"]


@pytest.mark.parametrize("text", [
    "k: 'quoted'\n", "k: \"quoted\"\n", "k: &anchor 1\n", "k: *alias\n",
    "k: !!float 1\n", "k: |\n  block\n", "k:\n  - item\n", "k: {a: 1}\n",
    "k: [1, [2]]\n", "k: [1, , 2]\n", "k: [1, 2\n", "k: 0x1f\n",
    "k: 1_000\n", "k: 1:30\n", "k: 2001-12-14\n", "---\nk: 1\n",
    "%YAML 1.1\nk: 1\n", "k: 1\nk: 2\n", "k:\n\tj: 1\n", "yes: 1\n",
    "k: 1\n  j: 2\n", "k: a: b\n", "k: [1] x\n", "",
])
def test_sensor_yaml_refuses(text):
    """Anything outside the subset raises instead of being guessed."""
    with pytest.raises(ValueError):
        sensor_yaml.loads(text)


def test_export_euroc_scene_matches(tmp_path):
    """The port's export against JAX's at 48x64, 3 frames: yaml and csv
    text equal, images within 1 LSB (equal, measured), and the ground
    truth depth to rtol 1e-5; the port's loader reads it back with the
    0.11 baseline and the RadTan coefficients."""
    jexport_euroc_scene(tmp_path / "jax", n_frames=3, image_shape=(48, 64))
    body = export_euroc_scene(tmp_path / "port", n_frames=3,
                              image_shape=(48, 64))
    assert len(body) == 3
    for name in ("cam0/sensor.yaml", "cam1/sensor.yaml", "cam0/data.csv",
                 "cam1/data.csv", "state_groundtruth_estimate0/data.csv"):
        assert ((tmp_path / "port" / name).read_text()
                == (tmp_path / "jax" / name).read_text()), name
    for cam in ("cam0", "cam1"):
        for path in sorted((tmp_path / "jax" / cam / "data").glob("*.png")):
            mine = imread(tmp_path / "port" / cam / "data" / path.name)
            assert np.abs(mine.astype(int)
                          - imread(path).astype(int)).max() <= 1
    for i in range(3):
        j = np.load(tmp_path / "jax" / "debug_gt" / f"{i}.npz")
        p = np.load(tmp_path / "port" / "debug_gt" / f"{i}.npz")
        np.testing.assert_allclose(p["depth"], j["depth"], rtol=1e-5)
        np.testing.assert_allclose(p["image"], j["image"], atol=1e-5)
    f0, f1 = EurocDataset(tmp_path / "port")[2]
    assert f0.image.shape == (48, 64) and f0.image.dtype == torch.uint8
    np.testing.assert_allclose(
        float(torch.linalg.norm(f1.pose.t.double() - f0.pose.t.double())),
        0.11, rtol=1e-5)
    np.testing.assert_allclose(
        f0.camera_model.distortion_model.dist_coeffs.numpy()[:4],
        [-0.08, 0.01, 5e-5, 1e-5], rtol=1e-6)


def test_camera_io_round_trip(tmp_path):
    """Camera files written by either package read back by the other as
    the same models (id, type and parameters)."""
    text = ["NoDistortion 500.0 501.0 320.0 240.0",
            "FOV 517.3 516.5 318.6 255.3 0.8",
            "RadTan 458.654 457.296 367.215 248.375 -0.28 0.07 0.0002 "
            "1.7e-05 0.0"]
    models = {i: CameraModel.fromstring(s) for i, s in zip((3, 0, 7), text)}
    jmodels = {i: JCameraModel.fromstring(s) for i, s in zip((3, 0, 7), text)}
    save_cameras(tmp_path / "port.txt", models)
    jsave_cameras(tmp_path / "jax.txt", jmodels)
    assert ((tmp_path / "port.txt").read_text()
            == (tmp_path / "jax.txt").read_text())
    back = load_cameras(tmp_path / "jax.txt")
    jback = jload_cameras(tmp_path / "port.txt")
    assert sorted(back) == sorted(jback) == [0, 3, 7]
    for i in back:
        assert str(back[i]) == str(jback[i]) == str(models[i])


def test_normalization_map_table():
    """The lookup table of a RadTan camera against JAX's: normalize to
    rtol 1e-6 on seeded in-image points, and in_range equal."""
    spec = ("RadTan 258.0 257.5 161.0 119.0 -0.28 0.07 0.0002 1.7e-05 "
            "0.0")
    shape = (48, 64)
    table = NormalizationMapTable(CameraModel.fromstring(spec), shape)
    jtable = JTable(JCameraModel.fromstring(spec), shape)
    gen = np.random.default_rng(12)
    us = (gen.random((500, 2)) * [63.0, 47.0]).astype(np.float32)
    np.testing.assert_allclose(table.normalize(torch.from_numpy(us)).numpy(),
                               np.asarray(jtable.normalize(jnp.asarray(us))),
                               rtol=1e-6, atol=1e-7)
    probe = np.float32([[0, 0], [63, 47], [63.5, 2], [-0.1, 5], [10, 47.2]])
    np.testing.assert_array_equal(
        table.in_range(torch.from_numpy(probe)).numpy(),
        np.asarray(jtable.in_range(jnp.asarray(probe))))


def test_points_scenes():
    """The point-cloud scenes equal the JAX package's."""
    np.testing.assert_array_equal(points.cubic_lattice(4),
                                  jpoints.cubic_lattice(4))
    for a, b in zip(points.donut(4, 8, height=3, point_density=8,
                                 n_viewpoints=10),
                    jpoints.donut(4, 8, height=3, point_density=8,
                                  n_viewpoints=10)):
        np.testing.assert_array_equal(a, b)
    rotations = Rotation.from_rotvec(
        np.random.default_rng(13).normal(0, 0.3, (6, 3))).as_matrix()
    pts = points.cubic_lattice(3)
    np.testing.assert_array_equal(
        points.generate_translations(rotations, pts),
        jpoints.generate_translations(rotations, pts))


def test_png_codec_rgba_against_pil(tmp_path):
    """RGBA both ways against PIL, bit for bit: the port writes and PIL
    reads; PIL writes (choosing its row filters) and the port reads."""
    from PIL import Image
    array = np.random.default_rng(14).integers(0, 256, (23, 31, 4),
                                               dtype=np.uint8)
    image_io.imsave(tmp_path / "port.png", array)
    with Image.open(tmp_path / "port.png") as img:
        assert img.mode == "RGBA"
        np.testing.assert_array_equal(np.asarray(img), array)
    Image.fromarray(array, mode="RGBA").save(tmp_path / "pil.png")
    np.testing.assert_array_equal(imread(tmp_path / "pil.png"), array)


@pytest.mark.parametrize("args", [
    {}, dict(n_frames=3, image_shape=(40, 56), focal_length=(50.0, 52.0),
             plane_origin=(0.5, -0.2, 6.0), plane_normal=(0.2, 0.1, -1.0))])
def test_plane_scene_dataset_matches_jax(args):
    """``PlaneSceneDataset`` takes the JAX signature (``n_frames``, one
    plane, ``orbit_poses`` by default) and renders the JAX frames:
    images within 2e-6 (the texture's sines and cosines round a few ulp
    apart in XLA and PyTorch: 1.2e-6 at most on 4 of 19200 pixels of the
    default scene), depth maps within 1e-6 relative, poses within 1e-6;
    integer, negative and slice indexing as ``BaseDataset``."""
    from tadataka_tpu.dataset import PlaneSceneDataset as JPlaneSceneDataset
    from tadataka_torch.dataset import PlaneSceneDataset
    from tadataka_torch.dataset.base import BaseDataset
    jds = JPlaneSceneDataset(**args)
    ds = PlaneSceneDataset(**args)
    assert isinstance(ds, BaseDataset) and len(ds) == len(jds)
    for frame, jframe in zip(ds[:], [jds[i] for i in range(len(jds))]):
        np.testing.assert_allclose(frame.image.numpy(),
                                   np.asarray(jframe.image), atol=2e-6)
        np.testing.assert_allclose(frame.depth_map.numpy(),
                                   np.asarray(jframe.depth_map), rtol=1e-6)
        np.testing.assert_allclose(frame.pose.T.numpy(),
                                   np.asarray(jframe.pose.T), atol=1e-6)
    assert torch.equal(ds[-1].image, ds.load(len(ds) - 1).image)
