"""The port's FeatureBasedVO over the JAX package's long-trajectory
gate (tests/vo/test_long_trajectory.py::test_feature_vo_long): the same
30 frames at 80x100 and the same thresholds, on the CPU, through seven
cycles of the 8-keyframe BA window.  The sequence and the drive are
``chip_smoke.py``'s (see ``test_torch_long_trajectory.py``)."""

import numpy as np

import chip_smoke
from tadataka_torch.metrics import absolute_trajectory_error


def test_feature_vo_long():
    """At least 28 of 30 frames posed, and the sim(3)-aligned ATE under
    30% of the extent (the JAX test's regression pin)."""
    frames = chip_smoke.long_sequence()
    _, poses = chip_smoke.long_feature(frames, "cpu")
    posed = [(p.t.numpy(), f.pose.t.numpy())
             for p, f in zip(poses, frames) if p is not None]
    assert len(posed) >= chip_smoke.N_LONG_FRAMES - 2, len(posed)
    est, gt = (np.stack(x) for x in zip(*posed))
    extent = np.linalg.norm(gt[-1] - gt[0])
    ate = float(absolute_trajectory_error(est, gt, align=True))
    assert ate < 0.3 * extent, (ate, extent)
