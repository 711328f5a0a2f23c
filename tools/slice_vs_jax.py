#!/usr/bin/env python3
"""A slice of chip_smoke.py through the JAX package and the port, both on
the CPU, at a reduced size; prints each app's quality per frame.

    JAX_PLATFORMS=cpu python tools/slice_vs_jax.py --scale 4
    JAX_PLATFORMS=cpu python tools/slice_vs_jax.py --scale 2 --init gt
    JAX_PLATFORMS=cpu python tools/slice_vs_jax.py --trajectory lateral
    JAX_PLATFORMS=cpu python tools/slice_vs_jax.py --app pipelined

The trajectory, parameters and frame count are those of phase 5 (the
homography sweep), or with ``--trajectory lateral`` those of the rect
phase (chip_smoke.LATERAL, N_RECT_FRAMES frames, the host pose chain
drained only at the end).  ``--app pipelined`` runs each package's
``PipelinedSemiDenseVO`` (tracker and mapper on one device) instead of
``SemiDenseVO``, as chip_smoke's pipelined phase does; its state lags
by a frame, so frame k is read after frame k + 1 (the last after
``flush_map``).  ``--scale k``
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

import jax  # noqa: E402

from tadataka_tpu.apps import PipelinedSemiDenseVO as JPipelined  # noqa
from tadataka_tpu.apps import SemiDenseVO as JSemiDenseVO  # noqa: E402
from tadataka_tpu.camera import CameraParameters as JCameraParameters  # noqa
from tadataka_tpu.core.pose import Pose as JPose  # noqa: E402
from tadataka_tpu.vo.semi_dense import SemiDenseParams as JParams  # noqa

import chip_smoke  # noqa: E402
from tadataka_torch.apps import PipelinedSemiDenseVO  # noqa: E402
from tadataka_torch.camera import CameraParameters  # noqa: E402
from tadataka_torch.dataset import multi_plane_scene  # noqa: E402
from tadataka_torch.vo.semi_dense import SemiDenseParams  # noqa: E402


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
    parser.add_argument("--app", choices=("semi_dense", "pipelined"),
                        default="semi_dense")
    args = parser.parse_args()
    if args.app == "pipelined" and (args.init == "gt"
                                    or args.trajectory == "lateral"):
        parser.error("--app pipelined takes the slice trajectory and the "
                     "random initial map")
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
    jcam = JCameraParameters.create((focal, focal), (W / 2.0, H / 2.0))
    jparams = JParams.create(2.0, 50.0, ref_step_size=0.002,
                             min_gradient=0.01)
    T10 = frames[1].pose.inv() * frames[0].pose
    jT10 = JPose(jnp.asarray(T10.R.numpy()), jnp.asarray(T10.t.numpy()))
    if args.app == "pipelined":
        cpu = jax.devices()[0]
        jvo = JPipelined(jcam, params=jparams, devices=(cpu, cpu), **va)
        vo = PipelinedSemiDenseVO(
            CameraParameters.create((focal, focal), (W / 2.0, H / 2.0)),
            params=SemiDenseParams.create(2.0, 50.0, ref_step_size=0.002,
                                          min_gradient=0.01),
            devices=("cpu", "cpu"), **va)
        return run_pipelined(args, jvo, vo, frames, images, jT10, T10,
                             (H, W), focal)
    jvo = JSemiDenseVO(jcam, params=jparams, metrics=jlog, **va, **init)
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
        last = compare(f"frame {k:2d} plan {jlog.frames[-1][1]['plan_path']}"
                       f"/{log.frames[-1][1]['plan_path']}", k, j, p,
                       frames[k])
    print(json.dumps(dict(trajectory=args.trajectory, shape=[H, W],
                          focal=focal, init=args.init, last=last)))


def compare(label, k, j, p, frame):
    """Both apps' readings of frame k; prints them after ``label``,
    returns them."""
    jq = quality(np.asarray(j.depth_map), np.asarray(j.flag_map),
                 np.asarray(j.pose_wc.t), frame)
    pq = quality(p.depth_map.numpy(), p.flag_map.numpy(),
                 p.pose_wc.t.numpy(), frame)
    pose_d = max(float(np.abs(np.asarray(j.pose_wc.R)
                              - p.pose_wc.R.numpy()).max()),
                 float(np.abs(np.asarray(j.pose_wc.t)
                              - p.pose_wc.t.numpy()).max()))
    flags_agree = float(np.mean(np.asarray(j.flag_map) == p.flag_map.numpy()))
    print(f"{label}: jax SUCCESS {jq['success']:.3f} err "
          f"{jq['median_err']:.4f} cos {jq['cos']:.4f} | port SUCCESS "
          f"{pq['success']:.3f} err {pq['median_err']:.4f} cos "
          f"{pq['cos']:.4f} | pose d {pose_d:.3g}, flags agree "
          f"{flags_agree:.4f}", flush=True)
    return dict(frame=k, jax=jq, port=pq, pose_d=pose_d,
                flags_agree=flags_agree)


def run_pipelined(args, jvo, vo, frames, images, jT10, T10, shape, focal):
    """Both pipelined apps over the frames; frame k is read after frame k
    + 1 is given (the map lags by one frame), the last after flush_map."""
    jvo.initial_pose_fn = lambda image0, image1: jT10
    vo.initial_pose_fn = lambda image0, image1: T10
    n = len(frames)
    print(f"pipelined app, slice trajectory, {shape[0]}x{shape[1]}, focal "
          f"{focal}, {n} frames, init random", flush=True)
    for k, image in enumerate(images):
        j = jvo.estimate(image)
        p = vo.estimate(image)
        if k >= 2:
            compare(f"frame {k - 1:2d}", k - 1, j, p, frames[k - 1])
    last = compare(f"frame {n - 1:2d}", n - 1, jvo.flush_map(),
                   vo.flush_map(), frames[-1])
    print(json.dumps(dict(app="pipelined", trajectory="slice",
                          shape=list(shape), focal=focal, init="random",
                          last=last)))


if __name__ == "__main__":
    main()
