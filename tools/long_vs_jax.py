#!/usr/bin/env python3
"""The JAX package's readings on the inputs of ``chip_smoke.py``'s
``long`` phase, part (b), on the CPU: the gates of that phase.

    JAX_PLATFORMS=cpu python tools/long_vs_jax.py [--part P] [--scales 4 2]

``--part``: ``semi_dense``, ``pipelined``, ``dvo``, ``feature`` or
``all`` (the default).

- ``semi_dense`` / ``pipelined``: the JAX ``SemiDenseVO`` /
  ``PipelinedSemiDenseVO`` (both stages on the one CPU device) over 30
  frames of phase 5's trajectory (``chip_smoke.trajectory(30)``) and
  settings, at 1/4 and 1/2 size (``--scales``: image and focal divided by
  k; 480x640 is too slow for the JAX package on the CPU), bootstrapped
  with the true pose as chip_smoke does; each frame's SUCCESS share,
  median |depth - GT| on SUCCESS pixels and cos(t_est, t_gt), and the
  last frame's (the pipelined app's flushed one).
- ``dvo``: the JAX ``DvoTrajectory(weights="huber", n_coarse_to_fine=4,
  max_iter=15)`` (no sample budget) over tests/vo/test_long_trajectory.py's
  30 poses at 480x640, focal 480, exact depth: unaligned ATE as a share
  of the extent, and the one-frame RPE.
- ``feature``: the JAX ``FeatureBasedVO`` with that test's settings over
  the same poses at 480x640 with the EuRoC export's high-frequency
  texture (the default texture gives 26 FAST corners at 6/255 at this
  size): frames posed and the aligned ATE as a share of the extent.

Every image is rendered by the port (``chip_smoke.py``'s helpers) and
given to the JAX package as float32 numpy.  The last line is one JSON
object of the readings.  Needs the JAX package, so it runs where the
tests run, not on the card; most of its time is JAX compiles.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from tadataka_torch.metrics import (  # noqa: E402
    absolute_trajectory_error, relative_pose_error)


def semi_dense_quality(state, frame):
    """(SUCCESS share, median |depth - GT| on SUCCESS, cos(t_est, t_gt))
    of a JAX state against the port-rendered frame."""
    success = np.asarray(state.flag_map) == 0
    err = np.abs(np.asarray(state.depth_map)
                 - frame.depth_map.numpy())[success]
    t_est = np.asarray(state.pose_wc.t, np.float64)
    t_gt = frame.pose.t.numpy().astype(np.float64)
    cos = float(t_est @ t_gt / (np.linalg.norm(t_est) * np.linalg.norm(t_gt)
                                + 1e-12))
    return dict(success=float(success.mean()),
                median_err=float(np.median(err)), cos=cos)


def semi_dense(app, scale):
    from tadataka_tpu.apps import PipelinedSemiDenseVO, SemiDenseVO
    from tadataka_tpu.camera import CameraParameters
    from tadataka_tpu.core.pose import Pose
    from tadataka_tpu.vo.semi_dense import SemiDenseParams
    from tadataka_torch.dataset import multi_plane_scene
    n = chip_smoke.N_LONG_FRAMES
    H, W = (k // scale for k in chip_smoke.VGA)
    focal = chip_smoke.VGA_FOCAL / scale
    ds = multi_plane_scene(n, (H, W), (focal, focal),
                           chip_smoke.trajectory(n))
    frames = [ds[i] for i in range(n)]
    cam = CameraParameters.create((focal, focal), (W / 2.0, H / 2.0))
    params = SemiDenseParams.create(2.0, 50.0, ref_step_size=0.002,
                                    min_gradient=0.01)
    T10 = frames[1].pose.inv() * frames[0].pose
    jT10 = Pose(jnp.asarray(T10.R.numpy()), jnp.asarray(T10.t.numpy()))
    if app == "pipelined":
        cpu = jax.devices()[0]
        vo = PipelinedSemiDenseVO(cam, params=params, devices=(cpu, cpu),
                                  **chip_smoke.SLICE_ARGS)
    else:
        vo = SemiDenseVO(cam, params=params, **chip_smoke.SLICE_ARGS)
    vo.initial_pose_fn = lambda image0, image1: jT10
    per_frame = []
    t0 = time.perf_counter()
    for k, frame in enumerate(frames):
        state = vo.estimate(frame.image.numpy())
        read = k - 1 if app == "pipelined" else k
        if read >= 1:
            per_frame.append(semi_dense_quality(state, frames[read]))
    if app == "pipelined":
        per_frame.append(semi_dense_quality(vo.flush_map(), frames[-1]))
    for k, q in enumerate(per_frame, start=1):
        print(f"[{app} 1/{scale}] frame {k:2d}: SUCCESS {q['success']:.4f}, "
              f"median err {q['median_err']:.4f}, cos {q['cos']:.4f}",
              flush=True)
    print(f"[{app} 1/{scale}] {H}x{W}, focal {focal}, {n} frames in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return dict(shape=[H, W], last=per_frame[-1])


class _Frame:
    """A JAX-side frame: image and depth as numpy, the JAX camera."""

    def __init__(self, frame, camera_model):
        self.image = frame.image.numpy()
        self.depth_map = frame.depth_map.numpy()
        self.camera_model = camera_model


def long_frames(texture=None):
    from tadataka_tpu.camera import CameraModel, CameraParameters
    H, W = chip_smoke.VGA
    f = chip_smoke.VGA_FOCAL
    frames = chip_smoke.long_sequence(chip_smoke.VGA, f, texture=texture)
    camera_model = CameraModel.create(CameraParameters.create(
        (f, f), (W / 2.0, H / 2.0)))
    gt = np.stack([x.pose.t.numpy() for x in frames]).astype(np.float64)
    return [_Frame(x, camera_model) for x in frames], gt


def dvo():
    from tadataka_tpu.apps import DvoTrajectory
    frames, gt = long_frames()
    vo = DvoTrajectory(frames[0].camera_model, weights="huber",
                       n_coarse_to_fine=4, max_iter=15)
    vo.estimator.sample_budget = 0
    t0 = time.perf_counter()
    for frame in frames:
        vo.estimate(frame)
    est = np.asarray(vo.positions(), np.float64)
    extent = float(np.linalg.norm(gt[-1] - gt[0]))
    out = dict(ate_share=float(absolute_trajectory_error(
        est, gt, align=False)) / extent,
        rpe=float(relative_pose_error(est, gt, delta=1)), extent=extent)
    print(f"[dvo] 480x640, {len(frames)} frames in "
          f"{time.perf_counter() - t0:.1f} s: unaligned ATE "
          f"{out['ate_share']:.6f} of the extent {extent:.4f}, RPE "
          f"{out['rpe']:.6f}", flush=True)
    return out


def feature():
    from tadataka_tpu.vo.feature_based import FeatureBasedVO
    from tadataka_torch.dataset.synthetic import _sharp_texture
    frames, gt = long_frames(texture=_sharp_texture)
    vo = FeatureBasedVO(**chip_smoke.LONG_FEATURE_VO)
    est, kept = [], []
    t0 = time.perf_counter()
    for k, frame in enumerate(frames):
        pose = vo.estimate(frame)
        if pose is not None:
            est.append(np.asarray(pose.t, np.float64))
            kept.append(gt[k])
    est, kept = np.stack(est), np.stack(kept)
    extent = float(np.linalg.norm(kept[-1] - kept[0]))
    out = dict(posed=len(est), frames=len(frames),
               ate_share=float(absolute_trajectory_error(est, kept))
               / extent, points=len(vo.point_dict))
    print(f"[feature] 480x640, {out['posed']} of {len(frames)} frames "
          f"posed in {time.perf_counter() - t0:.1f} s: aligned ATE "
          f"{out['ate_share']:.6f} of the extent, {out['points']} map "
          "points", flush=True)
    return out


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--part", default="all",
                        choices=["semi_dense", "pipelined", "dvo", "feature",
                                 "all"])
    parser.add_argument("--scales", type=int, nargs="+", default=[4, 2])
    args = parser.parse_args()
    parts = (["dvo", "feature", "semi_dense", "pipelined"]
             if args.part == "all" else [args.part])
    result = {}
    for part in parts:
        if part in ("semi_dense", "pipelined"):
            result[part] = {f"1/{s}": semi_dense(part, s)
                            for s in args.scales}
        else:
            result[part] = {"dvo": dvo, "feature": feature}[part]()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
