"""The DVO trajectory app and its ingestion path against the JAX package
on the CPU: ``DvoTrajectory`` over three frames, the TUM RGB-D loader on
a scene the JAX package exported, ``export_tum_scene``, the PNG codec
against PIL, and the trajectory and photometric metrics.
"""

import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tadataka_tpu.apps import DvoTrajectory as JDvoTrajectory
from tadataka_tpu.camera import resize as jresize
from tadataka_tpu.core.pose import Pose as JPose
from tadataka_tpu.dataset.frame import Frame as JFrame
from tadataka_tpu.dataset.synthetic import (
    export_tum_scene as jexport, render_plane_scene as jrender)
from tadataka_tpu.dataset.tum_rgbd import (
    TumRgbdDataset as JTumRgbdDataset, get_camera_model_rgb as jfreiburg)
from tadataka_tpu import metrics as jmetrics

from tadataka_torch import interop, metrics
from tadataka_torch.apps import DvoTrajectory, SemiDenseVO
from tadataka_torch.camera import CameraParameters
from tadataka_torch.core.pose import Pose
from tadataka_torch.dataset import (
    Frame, TumRgbdDataset, export_tum_scene, imread, imsave)


def port_camera(jcm):
    p = jcm.camera_parameters
    return interop.camera_model_from_numpy(
        p.focal_length, p.offset, type(jcm.distortion_model).__name__,
        jcm.distortion_model.params)


# --------------------------------------------------------- DvoTrajectory

@pytest.fixture(scope="module")
def tum_like_frames():
    """Three frames of export_tum_scene's trajectory and plane, rendered
    at 120x160 through the freiburg1 RadTan camera scaled by 1/4 (its
    intrinsics belong to 480x640), quantized as the exporter quantizes:
    uint8 RGB and depth through uint16 at 5000 x 1.035."""
    jcm = jresize(jfreiburg(1), 0.25)
    frames = []
    for i in range(3):
        pose = JPose.from_rotvec(
            jnp.asarray([0.0, 0.004 * i, 0.001 * i], jnp.float32),
            jnp.asarray([0.03 * i, 0.01 * i, 0.02 * i], jnp.float32))
        image, depth = jrender(jcm, pose, (120, 160),
                               plane_origin=(0.0, 0.0, 2.5),
                               plane_normal=(0.06, -0.04, -1.0))
        rgb8 = np.clip(np.asarray(image) * 255.0, 0, 255).astype(np.uint8)
        factor = np.float32(5000.0 * 1.035)
        dep16 = np.clip(np.asarray(depth) * factor, 0, 65535).astype(
            np.uint16)
        frames.append((pose, np.repeat(rgb8[:, :, None], 3, axis=2),
                       dep16.astype(np.float32) / factor))
    return jcm, frames


def test_dvo_trajectory_matches_jax(tum_like_frames):
    """``DvoTrajectory(weights="huber")`` with its defaults (5 levels, 20
    iterations) on the CPU: every position within 2e-4 m and rotation
    within 2e-4 of the JAX app's (the pyramid resize differs from
    ``jax.image.resize`` by ~1e-7, which moves coarse-level stops a
    little), and within 1 cm of the truth."""
    jcm, frames = tum_like_frames
    jvo = JDvoTrajectory(jcm, weights="huber")
    jvo.estimator.sample_budget = 0          # the gather path, as on the CPU
    vo = DvoTrajectory(port_camera(jcm), weights="huber", device="cpu")
    for k, (pose, rgb, depth) in enumerate(frames):
        if k == 1:
            vo.prefetch(Frame(None, None, rgb, depth))
        jvo.estimate(JFrame(jcm, pose, rgb, depth))
        vo.estimate(Frame(None, None, rgb, depth))
    np.testing.assert_allclose(vo.positions(), jvo.positions(), atol=2e-4)
    for p, jp in zip(vo.trajectory, jvo.trajectory):
        np.testing.assert_allclose(p.R.numpy(), np.asarray(jp.R), atol=2e-4)
    gt = np.stack([np.asarray(pose.t) for pose, _, _ in frames])
    assert np.abs(vo.positions() - gt).max() < 0.01


def test_apps_default_to_the_card():
    """Both apps run on the card unless given device="cpu", and raise
    instead of falling back when there is none."""
    cm = port_camera(jfreiburg(1))
    if torch.cuda.is_available():
        assert DvoTrajectory(cm).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DvoTrajectory(cm)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SemiDenseVO(CameraParameters.create((40.0, 40.0), (20.0, 15.0)))


# ------------------------------------------------------------ TUM RGB-D

def test_tum_loader_reads_a_jax_exported_scene(tmp_path):
    """The port's TumRgbdDataset on a scene written by the JAX package's
    export_tum_scene (36x48): the same frame count, timestamps, camera,
    images, depth and poses as the JAX loader, bit for bit."""
    jexport(tmp_path, n_frames=3, image_shape=(36, 48))
    jds = JTumRgbdDataset(tmp_path, which_freiburg=1)
    ds = TumRgbdDataset(tmp_path, which_freiburg=1)
    assert len(ds) == len(jds) == 3
    np.testing.assert_array_equal(ds.timestamps, jds.timestamps)
    assert str(ds.camera_model) == str(jds.camera_model)
    for frame, jframe in zip(ds[0:3], [jds[i] for i in range(3)]):
        np.testing.assert_array_equal(frame.image.numpy(), jframe.image)
        np.testing.assert_array_equal(frame.depth_map.numpy(),
                                      jframe.depth_map)
        np.testing.assert_array_equal(frame.pose.R.numpy(), jframe.pose.R)
        np.testing.assert_array_equal(frame.pose.t.numpy(), jframe.pose.t)
    assert ds[-1].image.shape == (36, 48, 3)


def test_tum_pose_files_round_trip(tmp_path):
    """Poses written by each package's ``save_in_tum_format`` read back
    equal through the other's ``load_tum_poses``; timestamps match the
    JAX ``match_timestamps`` and ``synchronize``."""
    from scipy.spatial.transform import Rotation
    from tadataka_tpu.dataset import tum as jtum
    from tadataka_torch.dataset import tum
    gen = np.random.default_rng(3)
    stamps = np.sort(gen.uniform(0, 10, 9))
    rotations = Rotation.from_rotvec(gen.normal(scale=0.3, size=(9, 3)))
    positions = gen.normal(size=(9, 3))
    tum.save_in_tum_format(tmp_path / "port.txt", stamps, rotations,
                           positions)
    jtum.save_in_tum_format(tmp_path / "jax.txt", stamps, rotations,
                            positions)
    assert (tmp_path / "port.txt").read_text() == \
        (tmp_path / "jax.txt").read_text()
    for (t, r, p), (jt, jr, jp) in ((tum.load_tum_poses(tmp_path / f),
                                      jtum.load_tum_poses(tmp_path / f))
                                     for f in ("port.txt", "jax.txt")):
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_array_equal(r.as_quat(), jr.as_quat())
        np.testing.assert_array_equal(p, jp)
    other = np.sort(gen.uniform(0, 10, 12))
    third = np.sort(gen.uniform(0, 10, 7))
    np.testing.assert_array_equal(tum.match_timestamps(stamps, other, 0.3),
                                  jtum.match_timestamps(stamps, other, 0.3))
    np.testing.assert_array_equal(tum.synchronize(stamps, other, third),
                                  jtum.synchronize(stamps, other, third))


def test_export_tum_scene_matches_jax(tmp_path):
    """The port's exporter writes the JAX exporter's scene: the same
    index files' timestamps and poses (within 1e-6), and images and
    depth PNGs within one quantization step (the two renderers round
    the RadTan undistort and the ray casts an ulp apart), equal on >= 99%
    of the pixels."""
    jexport(tmp_path / "jax", n_frames=2, image_shape=(36, 48))
    poses = export_tum_scene(tmp_path / "port", n_frames=2,
                             image_shape=(36, 48))
    jds = JTumRgbdDataset(tmp_path / "jax", 1)
    ds = TumRgbdDataset(tmp_path / "port", 1)
    np.testing.assert_array_equal(ds.timestamps, jds.timestamps)
    for k, (frame, jframe) in enumerate(zip(ds[:], [jds[0], jds[1]])):
        np.testing.assert_allclose(frame.pose.t.numpy(), jframe.pose.t,
                                   atol=1e-6)
        np.testing.assert_allclose(frame.pose.R.numpy(), jframe.pose.R,
                                   atol=1e-6)
        np.testing.assert_allclose(poses[k].t.numpy(), jframe.pose.t,
                                   atol=1e-6)
        image = frame.image.numpy().astype(int)
        assert np.abs(image - jframe.image).max() <= 1
        assert np.mean(image == jframe.image) >= 0.99
        step = 1.0 / ds.depth_factor
        assert np.abs(frame.depth_map.numpy() - jframe.depth_map).max() \
            <= step * 1.001


# ------------------------------------------------------------ PNG codec

def png_with_filters(array, filters):
    """A PNG of ``array`` (gray8, RGB8 or gray16) whose row y uses row
    filter ``filters[y % len(filters)]`` -- the five PNG filters, written
    here so that the port's reader meets each one."""
    color, depth = {(2, "uint8"): (0, 8), (3, "uint8"): (2, 8),
                    (2, "uint16"): (0, 16)}[(array.ndim, array.dtype.name)]
    if depth == 16:
        array = array.astype(">u2")
    H = array.shape[0]
    rows = np.ascontiguousarray(array).view(np.uint8).reshape(H, -1)
    rows = rows.astype(np.int64)
    bpp = (3 if color == 2 else 1) * depth // 8
    out = []
    for y in range(H):
        kind = filters[y % len(filters)]
        x = rows[y]
        up = rows[y - 1] if y else np.zeros_like(x)
        a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        if kind == 0:
            f = x
        elif kind == 1:
            f = x - a
        elif kind == 2:
            f = x - up
        elif kind == 3:
            f = x - (a + up) // 2
        else:
            p = a + up - c
            pa, pb, pc = np.abs(p - a), np.abs(p - up), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, up, c))
            f = x - pred
        out.append(np.concatenate([[kind], f % 256]).astype(np.uint8))
    data = zlib.compress(np.concatenate(out).tobytes())

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    header = struct.pack(">IIBBBBB", array.shape[1], H, depth, color, 0, 0,
                         0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", data) + chunk(b"IEND", b""))


def images(seed=0):
    gen = np.random.default_rng(seed)
    return {"gray8": gen.integers(0, 256, (13, 17), dtype=np.uint8),
            "rgb8": gen.integers(0, 256, (11, 9, 3), dtype=np.uint8),
            "gray16": gen.integers(0, 65536, (7, 19), dtype=np.uint16)}


@pytest.mark.parametrize("fmt", ["gray8", "rgb8", "gray16"])
def test_png_codec_against_pil(tmp_path, fmt):
    """Both directions against PIL, bit for bit: the port writes and PIL
    reads; PIL writes and the port reads; and the port reads PNGs whose
    rows cycle through all five filters, as PIL reads them."""
    array = images()[fmt]
    imsave(tmp_path / "port.png", array)
    with Image.open(tmp_path / "port.png") as img:
        np.testing.assert_array_equal(np.asarray(img), array)
    pil = Image.fromarray(array.astype(np.int32), mode="I").convert("I;16") \
        if fmt == "gray16" else Image.fromarray(array)
    pil.save(tmp_path / "pil.png")
    back = imread(tmp_path / "pil.png")
    assert back.dtype == array.dtype
    np.testing.assert_array_equal(back, array)
    for filters in ([0], [1], [2], [3], [4], [4, 3, 2, 1, 0]):
        (tmp_path / "f.png").write_bytes(png_with_filters(array, filters))
        with Image.open(tmp_path / "f.png") as img:
            np.testing.assert_array_equal(np.asarray(img), array)
        np.testing.assert_array_equal(imread(tmp_path / "f.png"), array)


def test_png_codec_refuses(tmp_path):
    with pytest.raises(ValueError, match="unsupported array"):
        imsave(tmp_path / "x.png", np.zeros((4, 4), np.float32))
    Image.fromarray(np.zeros((4, 4, 2), np.uint8), mode="LA").save(
        tmp_path / "a.png")
    with pytest.raises(ValueError, match="unsupported PNG"):
        imread(tmp_path / "a.png")
    (tmp_path / "b.png").write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        imread(tmp_path / "b.png")


# -------------------------------------------------------------- metrics

def test_trajectory_metrics_match_jax():
    """Umeyama alignment, ATE (aligned and not) and RPE against JAX's,
    within float32 rounding (1e-5), on a scaled, rotated, noisy copy of
    a trajectory."""
    gen = np.random.default_rng(7)
    gt = np.cumsum(gen.normal(scale=0.1, size=(12, 3)), 0).astype(np.float32)
    R = np.asarray(JPose.from_rotvec(jnp.float32([0.1, -0.3, 0.2]),
                                     jnp.zeros(3)).R)
    est = (0.7 * gt @ R.T + np.float32([0.3, -0.1, 0.5])
           + gen.normal(scale=0.01, size=gt.shape)).astype(np.float32)
    for port, ref in zip(metrics.umeyama_alignment(est, gt),
                         jmetrics.umeyama_alignment(jnp.asarray(est),
                                                    jnp.asarray(gt))):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=1e-5)
    for align in (True, False):
        np.testing.assert_allclose(
            float(metrics.absolute_trajectory_error(est, gt, align)),
            float(jmetrics.absolute_trajectory_error(
                jnp.asarray(est), jnp.asarray(gt), align)), rtol=1e-5)
    for delta in (1, 3):
        np.testing.assert_allclose(
            float(metrics.relative_pose_error(torch.from_numpy(est),
                                              torch.from_numpy(gt), delta)),
            float(jmetrics.relative_pose_error(jnp.asarray(est),
                                               jnp.asarray(gt), delta)),
            rtol=1e-5)


def test_photometric_error_matches_jax(tum_like_frames):
    """photometric_error and PhotometricError against JAX's on the
    RadTan frames, at the identity and at the true pose: within 1e-4
    relative (at the true pose the error is 3e-4, a mean of small
    differences that the warp's float32 rounding, the undistort's 2e-6
    and the sums' order move by ~1e-5 relative)."""
    jcm, frames = tum_like_frames
    (p0, rgb0, D0), (p1, rgb1, _) = frames[0], frames[1]
    I0, I1 = (rgb[..., 0].astype(np.float32) / 255.0 for rgb in (rgb0, rgb1))
    cm = port_camera(jcm)
    jT10 = p1.inv() * p0
    for jpose in (JPose.identity(), jT10):
        ref = float(jmetrics.PhotometricError(jcm, jcm, I0, D0, I1)(jpose))
        port = float(metrics.PhotometricError(
            cm, cm, *(torch.from_numpy(x) for x in (I0, D0, I1)))(
            Pose(torch.tensor(np.asarray(jpose.R)),
                 torch.tensor(np.asarray(jpose.t)))))
        np.testing.assert_allclose(port, ref, rtol=1e-4)


def test_export_tum_scene_seed(tmp_path):
    """``seed`` is taken as the JAX exporter takes it and draws nothing:
    the files are those of the default seed, byte for byte, and the
    index files' timestamps are the JAX exporter's with that seed."""
    export_tum_scene(tmp_path / "default", n_frames=2, image_shape=(12, 16))
    export_tum_scene(tmp_path / "seeded", n_frames=2, image_shape=(12, 16),
                     seed=7)
    jexport(tmp_path / "jax", n_frames=2, image_shape=(12, 16), seed=7)
    files = sorted(p.relative_to(tmp_path / "default")
                   for p in (tmp_path / "default").rglob("*") if p.is_file())
    assert len(files) == 7
    for name in files:
        assert (tmp_path / "seeded" / name).read_bytes() == \
            (tmp_path / "default" / name).read_bytes(), name
    for index in ("rgb.txt", "depth.txt"):
        assert (tmp_path / "seeded" / index).read_text() == \
            (tmp_path / "jax" / index).read_text()
