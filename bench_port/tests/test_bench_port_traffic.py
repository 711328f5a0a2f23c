"""The traffic generator: deterministic by seed, a closed loop whose
frames are all distinct, the same period of frames for every seed, at
the speeds the mix states; a mix is added as a file."""

import json
import math

import numpy as np
import pytest

from bench_port.harness.spec import load_config, load_benchmark
from bench_port.harness.traffic import draw, load_mix, loop_poses, make_loop
from bench_port.tests.small import small

MIXES = ("forward",)
FR1_XYZ = (0.244, 8.920)     # TUM's published mean m/s and deg/s
RATE_HZ = 30


def frame_steps(poses):
    """(metres, radians) from each frame to the next, around the loop."""
    n = len(poses)
    moves, turns = [], []
    for i in range(n):
        a, b = poses[i], poses[(i + 1) % n]
        moves.append(np.linalg.norm(b[:3, 3] - a[:3, 3]))
        c = (np.trace(a[:3, :3].T @ b[:3, :3]) - 1) / 2
        turns.append(math.acos(min(1.0, max(-1.0, c))))
    return np.array(moves), np.array(turns)


def config_of(name):
    bench = load_benchmark()
    entry = next(c for c in bench["configs"] if c["name"] == name)
    return small(load_config(entry))


@pytest.mark.parametrize("mix", MIXES)
def test_loop_closes_and_never_repeats_a_pose(mix):
    m = load_mix(mix)
    poses = loop_poses(m)
    assert len(poses) == 2 * m["leg"] + 2 * m["turn"] - 2
    steps = [np.linalg.norm(poses[(i + 1) % len(poses)][:3, 3]
                            - poses[i][:3, 3]) for i in range(len(poses))]
    # the loop closes: the step from the last frame back to the first is
    # a turn step, no longer than a leg step, and the wobble comes round
    assert steps[-1] == pytest.approx(np.linalg.norm(m["offset"]) / m["turn"])
    assert max(steps) <= np.linalg.norm(m["step"]) + 1e-12
    assert len(poses) % m["wobble"]["period_frames"] == 0
    keys = {tuple(np.round(T.ravel(), 9)) for T in poses}
    assert len(keys) == len(poses)


def test_forward_moves_at_freiburg1_xyz_speeds():
    moves, turns = frame_steps(loop_poses(load_mix("forward")))
    metres, degrees = FR1_XYZ
    assert moves == pytest.approx(metres / RATE_HZ, rel=1e-6)
    assert math.degrees(turns.mean()) * RATE_HZ == pytest.approx(
        degrees, rel=1e-3)


def test_a_mix_added_as_a_file(tmp_path):
    mix = dict(load_mix("forward"), leg=10, turn=2)
    mix["wobble"] = {"amplitude_rad": 0.01, "period_frames": 11}
    (tmp_path / "short.json").write_text(json.dumps(mix))
    poses = loop_poses(load_mix("short", directory=tmp_path))
    assert len(poses) == 2 * 10 + 2 * 2 - 2 == 22
    assert not np.allclose(poses[5][:3, :3], np.eye(3))


@pytest.mark.parametrize("config", ["semidense-tum-fr1", "dvo-tum-fr1"])
def test_same_seed_same_frames_other_seed_same_period(config):
    cfg = config_of(config)
    mix = load_mix("forward")
    a = make_loop(cfg, mix, 2**31 + 17, "cpu")
    b = make_loop(cfg, mix, 2**31 + 17, "cpu")
    c = make_loop(cfg, mix, 2**31 + 18, "cpu")
    assert (a.start, a.phase) == (b.start, b.phase)
    for fa, fb in zip(a.frames, b.frames):
        assert np.array_equal(fa.image, fb.image)
        if fa.depth_map is not None:
            assert np.array_equal(fa.depth_map, fb.depth_map)
    # another seed: the same period of frames, replayed from another
    # start, so the work is the same
    for fa, fc in zip(a.frames, c.frames):
        assert np.array_equal(fa.pose, fc.pose)
        assert np.array_equal(fa.image, fc.image)
    starts = {make_loop(cfg, mix, seed, "cpu").start
              for seed in range(2**31, 2**31 + 8)}
    assert len(starts) > 1
    first = a.frames[0].image
    assert first.dtype == np.uint8 and first.shape == (30 * 4, 40 * 4, 3)


def test_start_stays_on_the_out_leg_and_depth_in_range():
    mix = load_mix("forward")
    starts = {draw(seed, mix) for seed in range(2**31, 2**31 + 200)}
    assert starts <= set(range(mix["leg"] // 2))
    cfg = config_of("dvo-tum-fr1")
    loop = make_loop(cfg, mix, 5, "cpu")
    depths = np.stack([f.depth_map for f in loop.frames])
    assert 2.0 < depths.min() and depths.max() < 13.0
    # TUM's 16-bit quantisation at factor 5000
    scaled = depths.astype(np.float64) * 5000.0
    assert np.abs(scaled - np.round(scaled)).max() < 1e-2
