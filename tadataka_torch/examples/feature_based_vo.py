"""Feature-based VO demo (the port of ``examples/feature_based_vo.py``).

    python -m tadataka_torch.examples.feature_based_vo [--frames N] [--plot]
        [--device cuda|cpu]

FAST/BRIEF matching, PnP, triangulation and windowed BA over the
synthetic multi-plane scene at 120x160; prints each frame's position,
the sim(3)-aligned ATE and the map's size.  RANSAC draws come from the
VO's own generator (seeded), not from JAX's PRNG.
"""

import argparse

import numpy as np
import torch

from tadataka_torch.core.pose import Pose
from tadataka_torch.device import resolve_device
from tadataka_torch.examples import add_device_flag
from tadataka_torch.metrics import absolute_trajectory_error
from tadataka_torch.vo.feature_based import FeatureBasedVO


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--frames", type=int, default=5)
    parser.add_argument("--plot", action="store_true")
    add_device_flag(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    from tadataka_torch.dataset.synthetic import multi_plane_scene
    poses = [Pose.from_rotvec(torch.tensor([0.0, 0.002 * i, 0.0]),
                              torch.tensor([0.25 * i, 0.01 * i, 0.02 * i]))
             for i in range(args.frames)]
    ds = multi_plane_scene(n_frames=args.frames, image_shape=(120, 160),
                           focal_length=(120.0, 120.0), poses=poses)

    vo = FeatureBasedVO(window_size=8, min_matches=12, max_keypoints=512,
                        patch_size=24, fast_threshold=0.02, device=device)
    est, gt = [], []
    for i in range(args.frames):
        frame = ds[i]
        pose = vo.estimate(frame)
        if pose is None:
            print(f"frame {i}: tracking failed")
            continue
        est.append(pose.t.cpu().numpy())
        gt.append(frame.pose.t.numpy())
        print(f"frame {i}: t = {pose.t.cpu().numpy().round(3)}")

    est, gt = np.asarray(est), np.asarray(gt)
    ate = float(absolute_trajectory_error(est, gt))
    print(f"ATE (sim3-aligned): {ate:.4f}")

    points, colors = vo.export_points()
    print(f"map: {len(points)} points")

    if args.plot:
        from tadataka_torch.viz import plot_map
        plot_map([p.inv() for p in vo.export_poses()], points)


if __name__ == "__main__":
    main()
