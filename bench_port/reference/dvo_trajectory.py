"""The plain reference of a DvoTrajectory frame, and the check of the
frames a run sampled.

Each frame's pose change depends only on that frame and the one before
it, which the run hands over as host arrays, so the reference works the
images, the depth and the camera's pyramid grids out again and runs the
frozen copy of ``vo/dvo.py``'s pyramid with the app's arguments.  The
world pose composes the program's previous pose (its state) with the
inverse of the pose change; the first frame's pose is the identity."""

import numpy as np
import torch

from bench_port.harness.traffic import camera_model
from bench_port.reference.common import (
    Gaps, bf16, frame_points, host_T, map_gap, pose_gap_mm, rgb2gray)
from bench_port.reference.port.vo.dvo import (
    estimate_pose_pyramid, normalized_grids)

LAYER_SIZE_RATIO = 1.5     # DvoTrajectory's pyramid ratio (its default)


def pose_change(cm, grids, I0, D0, I1, args):
    R, t = estimate_pose_pyramid(
        cm, cm, I0, D0, I1, torch.ones_like(I0),
        torch.eye(3, device=I0.device), torch.zeros(3, device=I0.device),
        args["n_coarse_to_fine"], args["max_iter"], LAYER_SIZE_RATIO,
        args["weights"], "ic", grids)
    return host_T(R, t)


def check(captures, loop, config, seed, device, err=None, control=False):
    """{"pose_gap_mm": ...} of the sampled frames:
    the program's outputs against the reference's, or with ``control``
    the reference held in bfloat16 against the reference."""
    args = config["app_args"]
    cm = camera_model(config, device)
    grids = normalized_grids(cm, args["n_coarse_to_fine"], LAYER_SIZE_RATIO,
                             tuple(config["image_shape"]))
    points = frame_points(config)
    q = bf16 if control else (lambda x: x)

    def inputs(k):
        f = loop.frame(k)
        return (torch.from_numpy(rgb2gray(f.image)).to(device),
                torch.from_numpy(f.depth_map).to(device))

    gaps = Gaps()
    for k in sorted(captures):
        c = captures[k]
        if "out" not in c:
            continue
        out = c["out"]
        T_out = host_T(out.R, out.t)
        if k == 0:
            gaps.add_pose(k, 0.0 if control
                          else pose_gap_mm(T_out, np.eye(4), points))
            continue
        (I0, D0), (I1, _) = inputs(k - 1), inputs(k)
        T_prev = host_T(c["prev"].R, c["prev"].t)
        T_ref = T_prev @ np.linalg.inv(pose_change(cm, grids, I0, D0, I1,
                                                   args))
        if control:
            T_judged = T_prev @ np.linalg.inv(pose_change(
                cm, grids, q(I0), q(D0), q(I1), args))
        else:
            T_judged = T_out
            t_args = c["track"][0]
            for name, x, r in (("image 0", t_args[2], I0),
                               ("depth 0", t_args[3], D0),
                               ("image 1", t_args[4], I1)):
                gaps.add_map(name, map_gap(x, r))
        gaps.add_pose(k, pose_gap_mm(T_judged, T_ref, points))
    pose, _ = gaps.numbers(err, "control: " if control else "")
    # the inputs' gaps are printed, not compared: the control holds
    # them as the program does, so they separate nothing
    return {"pose_gap_mm": pose}
