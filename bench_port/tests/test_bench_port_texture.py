"""The scene's texture comes from the configuration: without the key,
or with "default", the frames are those the renderer gave before a
configuration could name one, bit for bit; "sharp" gives FAST corners
through EuRoC's cam0 camera, where the default texture gives none."""

import json

import numpy as np
import pytest
import torch

from bench_port.harness import traffic
from bench_port.harness.spec import load_benchmark, load_config
from bench_port.reference.port.core.pose import Pose
from bench_port.tests.small import small

# EuRoC MAV cam0 (Burri et al., IJRR 2016): 752x480, RadTan k1 k2 p1 p2
# and k3 = 0; the planes of the port's EuRoC export, 1.4-2.5 m away
EUROC_CAM0 = {"fx": 458.654, "fy": 457.296, "cx": 367.215, "cy": 248.375,
              "radtan": [-0.28340811, 0.07395907, 0.00019359,
                         1.76187114e-05, 0.0]}
EUROC_PLANES = [[[0.0, 0.0, 2.5], [0.06, -0.04, -1.0]],
                [[-0.5, 0.0, 1.9], [0.5, 0.0, -1.0]],
                [[0.5, 0.3, 2.1], [-0.45, -0.25, -1.0]]]


def render_before(rays, pose_wc, shape, planes, phase):
    """The renderer as it was before the texture was a configuration's:
    the default texture always."""
    H, W = shape
    device = rays.device
    f32 = torch.float32
    o_w = pose_wc.t
    d_w = rays @ pose_wc.R.T
    best_s = torch.full((H * W,), float("inf"), dtype=f32, device=device)
    best_xy = torch.zeros((H * W, 2), dtype=f32, device=device)
    for k, (origin, normal) in enumerate(planes):
        p0 = torch.tensor(origin, dtype=f32, device=device)
        n = torch.tensor(normal, dtype=f32, device=device)
        n = n / torch.linalg.norm(n)
        denom = d_w @ n
        s = ((p0 - o_w) @ n) / torch.where(torch.abs(denom) < 1e-9, 1e-9,
                                           denom)
        s = torch.where(s > 0, s, float("inf"))
        X_w = o_w + s[:, None] * d_w
        closer = s < best_s
        best_s = torch.where(closer, s, best_s)
        best_xy = torch.where(closer[:, None], X_w[:, :2] + 3.1 * k, best_xy)
    best_s = torch.where(torch.isinf(best_s), 100.0, best_s)
    image = traffic.default_texture(best_xy[:, 0] + phase[0],
                                    best_xy[:, 1] + phase[1]).reshape(H, W)
    return image, best_s.reshape(H, W)


def frames_before(config, mix):
    """(uint8 images, depth maps) of one period, as ``make_loop`` made
    them with ``render_before``."""
    phase = tuple(float(x) for x in mix["texture_phase"])
    shape = tuple(config["image_shape"])
    rays = traffic.pixel_rays(traffic.camera_model(config), shape, "cpu")
    planes = [tuple(map(tuple, p)) for p in config["planes"]]
    factor = config.get("depth_factor")
    images, depths = [], []
    for T in traffic.loop_poses(mix):
        pose = Pose(torch.as_tensor(T[:3, :3], dtype=torch.float32),
                    torch.as_tensor(T[:3, 3], dtype=torch.float32))
        image, depth = render_before(rays, pose, shape, planes, phase)
        u8 = torch.clamp(image * 255.0, 0, 255).to(torch.uint8)
        images.append(u8[:, :, None].expand(*shape, 3).numpy())
        if factor is not None:
            d16 = torch.clamp(depth * factor, 0, 65535).to(torch.int32)
            depths.append((d16.to(torch.float32) / factor).numpy())
    return images, depths


def config_of(name):
    entry = next(c for c in load_benchmark()["configs"] if c["name"] == name)
    return small(load_config(entry))


@pytest.mark.parametrize("texture", [None, "default"])
@pytest.mark.parametrize("name", ["semidense-tum-fr1", "dvo-tum-fr1"])
def test_default_texture_renders_todays_frames(name, texture):
    config = config_of(name)
    assert "texture" not in config
    if texture is not None:
        config["texture"] = texture
    mix = traffic.load_mix("forward")
    loop = traffic.make_loop(config, mix, 2**31 + 29, "cpu")
    images, depths = frames_before(config, mix)
    assert len(loop.frames) == len(images)
    for frame, image in zip(loop.frames, images):
        assert np.array_equal(frame.image, image)
    for frame, depth in zip(loop.frames, depths):
        assert np.array_equal(frame.depth_map, depth)


def euroc_frame(texture, scale=2, phase=(0.0, 0.0)):
    """One frame of the EuRoC planes through cam0 cut by ``scale``, as
    gray float32 in [0, 1] from the uint8 image."""
    config = {"image_shape": [480 // scale, 752 // scale],
              "camera": dict(EUROC_CAM0, **{
                  k: EUROC_CAM0[k] / scale for k in ("fx", "fy", "cx", "cy")}),
              "planes": EUROC_PLANES, "texture": texture}
    shape = tuple(config["image_shape"])
    rays = traffic.pixel_rays(traffic.camera_model(config), shape, "cpu")
    image, _ = traffic.render(
        rays, Pose(torch.eye(3), torch.zeros(3)), shape,
        [tuple(map(tuple, p)) for p in EUROC_PLANES], phase,
        traffic.texture_of(config))
    return torch.clamp(image * 255.0, 0, 255).to(torch.uint8).float() / 255.0


def test_sharp_texture_gives_fast_corners_at_euroc_cam0():
    from tadataka_torch.features.detector import detect_fast
    corners = {t: int(detect_fast(euroc_frame(t), threshold=10 / 255.0,
                                  max_keypoints=4096).mask.sum())
               for t in ("default", "sharp")}
    # 3671 against 0 at 376x240; 1280 against 0 at the full 752x480
    assert corners["sharp"] > 500
    assert corners["sharp"] >= 20 * max(corners["default"], 1)


@pytest.mark.parametrize("texture", ["default", "sharp"])
def test_the_mix_phase_moves_either_texture(texture):
    a = euroc_frame(texture, scale=8)
    b = euroc_frame(texture, scale=8, phase=(0.37, -0.21))
    assert not torch.equal(a, b)


def test_an_unknown_texture_is_refused():
    with pytest.raises(KeyError, match="texture 'marble'"):
        traffic.texture_of({"texture": "marble"})
    assert traffic.texture_of({}) is traffic.default_texture
    assert traffic.texture_of({"texture": "sharp"}) is traffic.sharp_texture


def test_a_configuration_names_its_texture_as_an_entry(tmp_path):
    config = dict(config_of("dvo-tum-fr1"), texture="sharp")
    (tmp_path / "c.json").write_text(json.dumps(config))
    loaded = load_config({"file": "c.json"}, tmp_path)
    assert traffic.texture_of(loaded) is traffic.sharp_texture


def test_sharp_texture_is_the_ports():
    from tadataka_torch.dataset.synthetic import _sharp_texture
    X, Y = torch.meshgrid(torch.linspace(-3, 3, 97), torch.linspace(-2, 5, 89),
                          indexing="ij")
    assert torch.equal(traffic.sharp_texture(X, Y), _sharp_texture(X, Y))
