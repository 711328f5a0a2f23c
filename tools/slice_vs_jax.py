#!/usr/bin/env python3
"""A slice of chip_smoke.py through the JAX package and the port, both on
the CPU, at a reduced size; prints each app's quality per frame.

    JAX_PLATFORMS=cpu python tools/slice_vs_jax.py --scale 4
    JAX_PLATFORMS=cpu python tools/slice_vs_jax.py --scale 2 --init gt
    JAX_PLATFORMS=cpu python tools/slice_vs_jax.py --trajectory lateral

The trajectory, parameters and frame count are those of phase 5 (the
homography sweep), or with ``--trajectory lateral`` those of the rect
phase (chip_smoke.LATERAL, N_RECT_FRAMES frames, the host pose chain
drained only at the end).  ``--scale k``
divides the image size (480x640) and the focal length (480) by k, which
keeps the field of view and every angle of the scene; only the pixel
pitch changes.  ``--init gt`` starts both maps at the true depth of
frame 0 instead of the seeded random map.  Needs the JAX package, so it
runs where the tests run, not on the card.  The last line is a JSON
object of the last frame's readings.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax.numpy as jnp  # noqa: E402

from tadataka_tpu.apps import SemiDenseVO as JSemiDenseVO  # noqa: E402
from tadataka_tpu.camera import CameraParameters as JCameraParameters  # noqa
from tadataka_tpu.core.pose import Pose as JPose  # noqa: E402
from tadataka_tpu.vo.semi_dense import SemiDenseParams as JParams  # noqa

import chip_smoke  # noqa: E402
from tadataka_torch.dataset import multi_plane_scene  # noqa: E402


def quality(depth, flags, t_est, frame):
    success = flags == 0
    err = np.abs(depth - frame.depth_map.numpy())[success]
    t_gt = frame.pose.t.numpy()
    cos = float(t_est @ t_gt / (np.linalg.norm(t_est) * np.linalg.norm(t_gt)
                                + 1e-12))
    return dict(success=float(success.mean()),
                median_err=float(np.median(err)),
                cos=cos)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scale", type=int, default=4)
    parser.add_argument("--init", choices=("random", "gt"), default="random")
    parser.add_argument("--trajectory", choices=("slice", "lateral"),
                        default="slice")
    args = parser.parse_args()
    H, W = (n // args.scale for n in chip_smoke.VGA)
    focal = chip_smoke.VGA_FOCAL / args.scale
    if args.trajectory == "lateral":
        n = chip_smoke.N_RECT_FRAMES
        poses = chip_smoke.trajectory(n, **chip_smoke.LATERAL)
    else:
        n = chip_smoke.N_FRAMES
        poses = chip_smoke.trajectory(n)
    ds = multi_plane_scene(n, (H, W), (focal, focal), poses)
    frames = [ds[i] for i in range(n)]
    images = [f.image.numpy() for f in frames]
    init = {}
    if args.init == "gt":
        init = dict(initial_depth_map=frames[0].depth_map.numpy())

    va = chip_smoke.SLICE_ARGS
    jlog, log = chip_smoke.PlanLog(), chip_smoke.PlanLog()
    jvo = JSemiDenseVO(
        JCameraParameters.create((focal, focal), (W / 2.0, H / 2.0)),
        params=JParams.create(2.0, 50.0, ref_step_size=0.002,
                              min_gradient=0.01),
        metrics=jlog, **va, **init)
    T10 = frames[1].pose.inv() * frames[0].pose
    jT10 = JPose(jnp.asarray(T10.R.numpy()), jnp.asarray(T10.t.numpy()))
    jvo.initial_pose_fn = lambda image0, image1: jT10
    vo = chip_smoke.make_vo((H, W), focal, "cpu", metrics=log, **init)
    vo.initial_pose_fn = lambda image0, image1: T10
    if args.trajectory == "lateral":
        # as the rect phase: the planner sees the constant-velocity
        # prediction from the bootstrap pose until the last frame
        jvo.pose_drain_interval = vo.pose_drain_interval = n

    print(f"{args.trajectory} trajectory, {H}x{W}, focal {focal}, {n} frames,"
          f" init {args.init}", flush=True)
    last = None
    for k, image in enumerate(images):
        j = jvo.estimate(image)
        p = vo.estimate(image)
        if k == 0:
            continue
        jq = quality(np.asarray(j.depth_map), np.asarray(j.flag_map),
                     np.asarray(j.pose_wc.t), frames[k])
        pq = quality(p.depth_map.numpy(), p.flag_map.numpy(),
                     p.pose_wc.t.numpy(), frames[k])
        pose_d = max(float(np.abs(np.asarray(j.pose_wc.R)
                                  - p.pose_wc.R.numpy()).max()),
                     float(np.abs(np.asarray(j.pose_wc.t)
                                  - p.pose_wc.t.numpy()).max()))
        flags_agree = float(np.mean(np.asarray(j.flag_map)
                                    == p.flag_map.numpy()))
        plan = (jlog.frames[-1][1]["plan_path"],
                log.frames[-1][1]["plan_path"])
        last = dict(frame=k, jax=jq, port=pq, pose_d=pose_d,
                    flags_agree=flags_agree)
        print(f"frame {k:2d} plan {plan[0]}/{plan[1]}: "
              f"jax SUCCESS {jq['success']:.3f} err {jq['median_err']:.4f} "
              f"cos {jq['cos']:.4f} | port SUCCESS {pq['success']:.3f} err "
              f"{pq['median_err']:.4f} cos {pq['cos']:.4f} | pose d "
              f"{pose_d:.3g}, flags agree {flags_agree:.4f}", flush=True)
    print(json.dumps(dict(trajectory=args.trajectory, shape=[H, W],
                          focal=focal, init=args.init, last=last)))


if __name__ == "__main__":
    main()
