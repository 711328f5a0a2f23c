"""VITAMIN-E visual odometry from dense curvature tracks (the port of
``examples/vitamin_e_vo.py``).

    python -m tadataka_torch.examples.vitamin_e_vo [--frames N] [--plot]
        [--device cuda|cpu]

Essential bootstrap, PnP a frame against the triangulated track map and
re-triangulation as the baseline grows, on the NewTsukuba fixture frames
where that fixture is present (``NEW_TSUKUBA_FIXTURE``), else on the
synthetic multi-plane scene at 120x160, as the JAX example chooses.
Prints each frame's position, tracks and map size, and the aligned ATE.
"""

import argparse

import numpy as np
import torch

from tadataka_torch.device import resolve_device
from tadataka_torch.examples import NEW_TSUKUBA_FIXTURE, add_device_flag
from tadataka_torch.metrics import absolute_trajectory_error
from tadataka_torch.vo.vitamin_e import VitaminEVO


def load_frames(n_frames):
    if NEW_TSUKUBA_FIXTURE.exists():
        from tadataka_torch.dataset.new_tsukuba import NewTsukubaDataset
        ds = NewTsukubaDataset(NEW_TSUKUBA_FIXTURE)
        frames = [ds[i][0] for i in range(min(n_frames, len(ds)))]
        return ds.camera_model, frames, 20.0 / 255.0
    from tadataka_torch.core.pose import Pose
    from tadataka_torch.dataset.synthetic import multi_plane_scene
    poses = [Pose.from_rotvec(torch.tensor([0.0, 0.003 * i, 0.0]),
                              torch.tensor([0.15 * i, 0.01 * i, 0.0]))
             for i in range(n_frames)]
    ds = multi_plane_scene(n_frames=n_frames, image_shape=(120, 160),
                           focal_length=(120.0, 120.0), poses=poses)
    frames = [ds[i] for i in range(n_frames)]
    return frames[0].camera_model, frames, 0.02


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--frames", type=int, default=5)
    parser.add_argument("--plot", action="store_true")
    add_device_flag(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    camera_model, frames, threshold = load_frames(args.frames)
    vo = VitaminEVO(camera_model, fast_threshold=threshold, lambda_=0.5,
                    device=device)

    est, gt = [], []
    for i, frame in enumerate(frames):
        pose = vo.estimate(frame.image)
        ok = pose is not None
        print(f"frame {i}: pose "
              f"{np.round(pose.t.cpu().numpy(), 3) if ok else 'LOST'}  "
              f"tracks {len(vo.keypoints[-1].ids)}  map {len(vo.points)}")
        if ok:
            est.append(pose.t.cpu().numpy())
            gt.append(frame.pose.t.numpy())

    if len(est) >= 3:
        ate = float(absolute_trajectory_error(np.stack(est), np.stack(gt)))
        print(f"ATE after Umeyama alignment: {ate:.4f} "
              f"(trajectory span {np.linalg.norm(gt[-1] - gt[0]):.2f})")

    if args.plot:
        from tadataka_torch.viz import plot_map
        pts = np.stack(list(vo.points.values()))
        plot_map([p.inv() for p in vo.poses_cw], pts)


if __name__ == "__main__":
    main()
