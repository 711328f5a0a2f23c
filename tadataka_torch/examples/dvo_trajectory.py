"""DVO trajectory demo (the port of ``examples/dvo_trajectory.py``).

    python -m tadataka_torch.examples.dvo_trajectory [--frames N] [--plot]
        [--device cuda|cpu]

Frame-chained RGB-D DVO over the synthetic multi-plane scene at 120x160;
prints the estimated positions and the unaligned ATE.
"""

import argparse

import numpy as np
import torch

from tadataka_torch.apps import DvoTrajectory
from tadataka_torch.core.pose import Pose
from tadataka_torch.device import resolve_device
from tadataka_torch.examples import add_device_flag
from tadataka_torch.metrics import absolute_trajectory_error


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--frames", type=int, default=6)
    parser.add_argument("--plot", action="store_true")
    add_device_flag(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    from tadataka_torch.dataset.synthetic import multi_plane_scene
    poses = [Pose.from_rotvec(torch.tensor([0.0, 0.003 * i, 0.0]),
                              torch.tensor([0.15 * i, 0.01 * i, 0.01 * i]))
             for i in range(args.frames)]
    ds = multi_plane_scene(n_frames=args.frames, image_shape=(120, 160),
                           focal_length=(120.0, 120.0), poses=poses)
    frames = [ds[i] for i in range(args.frames)]

    vo = DvoTrajectory(frames[0].camera_model, weights="huber",
                       n_coarse_to_fine=4, device=device)
    for frame in frames:
        vo.estimate(frame)

    est = vo.positions()
    gt = np.stack([f.pose.t.numpy() for f in frames])
    ate = float(absolute_trajectory_error(est, gt, align=False))
    print("positions:", est.round(4).tolist())
    print(f"ATE (metric, unaligned): {ate:.5f}")

    if args.plot:
        from tadataka_torch.viz import plot_trajectory
        plot_trajectory(est, gt)


if __name__ == "__main__":
    main()
