"""VITAMIN-E dense tracking demo (the port of ``examples/vitamin_e.py``).

    python -m tadataka_torch.examples.vitamin_e [--frames N] [--plot]
        [--device cuda|cpu]

Tracks curvature extrema through the synthetic multi-plane scene at
120x160 and triangulates the tracks with the true poses; prints the
tracks of each frame and the triangulated count.
"""

import argparse

import numpy as np
import torch

from tadataka_torch.core.pose import Pose
from tadataka_torch.device import resolve_device
from tadataka_torch.examples import add_device_flag
from tadataka_torch.vo.vitamin_e import track_sequence, triangulate_tracks


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--frames", type=int, default=4)
    parser.add_argument("--plot", action="store_true")
    add_device_flag(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    from tadataka_torch.dataset.synthetic import multi_plane_scene
    poses = [Pose.from_rotvec(torch.tensor([0.0, 0.003 * i, 0.0]),
                              torch.tensor([0.15 * i, 0.01 * i, 0.0]))
             for i in range(args.frames)]
    ds = multi_plane_scene(n_frames=args.frames, image_shape=(120, 160),
                           focal_length=(120.0, 120.0), poses=poses)
    frames = [ds[i] for i in range(args.frames)]
    images = [f.image.to(device) for f in frames]

    keypoints = track_sequence(images, lambda_=0.5, patch_size=24,
                               fast_threshold=0.02)
    for i, kf in enumerate(keypoints):
        print(f"frame {i}: {len(kf.ids)} tracked keypoints")

    camera_models = [f.camera_model.to(device) for f in frames]
    cam_poses = [f.pose.inv() for f in frames]
    points, depths = triangulate_tracks(camera_models, cam_poses, keypoints)
    points = points.cpu().numpy()
    ok = np.isfinite(points).all(axis=1) & np.all(depths.cpu().numpy() > 0,
                                                 axis=0)
    print(f"triangulated {ok.sum()} / {len(points)} tracks")

    if args.plot:
        from tadataka_torch.viz import plot_map
        plot_map([f.pose for f in frames], points[ok])


if __name__ == "__main__":
    main()
