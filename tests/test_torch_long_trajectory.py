"""The port over the JAX package's long-trajectory gate
(tests/vo/test_long_trajectory.py): the same 30-frame multi-plane
sequence at 80x100, focal 80, and the same thresholds, on the CPU.

Short clips cannot see drift-class faults: keyframe eviction, history
cycling, map decay.  This file holds DVO chaining and the semi-dense map
upkeep; ``test_torch_long_trajectory_feature.py`` holds the feature VO
(two files, so that the test run's workers can take them apart).  The
drive functions are ``chip_smoke.py``'s, which also runs them on the
card against the CPU; the gates are absolute, so no JAX run is needed.
"""

import numpy as np
import pytest

import chip_smoke
from tadataka_torch.flags import Flag
from tadataka_torch.metrics import (
    absolute_trajectory_error, relative_pose_error)


@pytest.fixture(scope="module")
def long_sequence():
    return chip_smoke.long_sequence()


def _gt_positions(seq):
    return np.stack([f.pose.t.numpy() for f in seq])


def test_dvo_trajectory_long(long_sequence):
    """Frame-chained DVO on exact depth: unaligned ATE under 5% of the
    extent and mean one-frame RPE under 0.02 over 30 frames."""
    est, _ = chip_smoke.long_dvo(long_sequence, "cpu")
    gt = _gt_positions(long_sequence)
    extent = np.linalg.norm(gt[-1] - gt[0])
    ate = float(absolute_trajectory_error(est, gt, align=False))
    assert ate < 0.05 * extent, (ate, extent)
    rpe = float(relative_pose_error(est, gt, delta=1))
    assert rpe < 0.02, rpe


def test_semi_dense_map_long(long_sequence):
    """The map upkeep over 30 frames with the true poses (propagate +
    increment_age, the planned update, regularize, a history of 4 cycled
    seven times): frame 29's median depth error within max(2 x frame
    3's, 0.8), and the SUCCESS share of the last flags over 0.1."""
    early, late, flags = chip_smoke.long_map(long_sequence, "cpu")
    assert late < max(2.0 * early, 0.8), (early, late)
    share = float((flags == int(Flag.SUCCESS)).float().mean())
    assert share > 0.1, share
