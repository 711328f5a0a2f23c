"""Depth from a stereo pair through the semi-dense epipolar estimator
(the port of ``examples/depth_from_stereo.py``).

    python -m tadataka_torch.examples.depth_from_stereo [--plot]
        [--device cuda|cpu]

Two frames of the synthetic multi-plane scene 0.5 apart at 120x160; one
``update_depth`` from a noisy prior; prints the flag histogram, the
SUCCESS share and the median depth error on SUCCESS pixels.
"""

import argparse

import numpy as np
import torch

from tadataka_torch.camera import CameraParameters
from tadataka_torch.core.pose import Pose
from tadataka_torch.device import resolve_device
from tadataka_torch.examples import add_device_flag
from tadataka_torch.flags import Flag
from tadataka_torch.utils.observability import flag_stats
from tadataka_torch.vo.semi_dense import (
    SemiDenseParams, make_frame, stack_frames, update_depth)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--plot", action="store_true")
    add_device_flag(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    H, W = 120, 160
    FOCAL = (120.0, 120.0)
    from tadataka_torch.dataset.synthetic import multi_plane_scene
    poses = [Pose.identity(),
             Pose.from_rotvec(torch.zeros(3), torch.tensor([0.5, 0.0, 0.0]))]
    ds = multi_plane_scene(n_frames=2, image_shape=(H, W),
                           focal_length=FOCAL, poses=poses)
    key, ref = ds[0], ds[1]

    cam = CameraParameters.create(FOCAL, (W / 2, H / 2), device=device)
    keyframe = make_frame(cam, key.image.to(device), key.pose.T.to(device))
    refframes = stack_frames([make_frame(cam, ref.image.to(device),
                                         ref.pose.T.to(device))])
    params = SemiDenseParams.create(2.0, 50.0, ref_step_size=0.002,
                                    min_gradient=0.01, device=device)

    gt = key.depth_map.numpy()
    rng = np.random.default_rng(0)
    prior = torch.from_numpy(
        gt + rng.uniform(-2, 2, gt.shape).astype(np.float32)).to(device)
    variance = 0.05 * torch.ones((H, W), device=device)
    age = torch.ones((H, W), dtype=torch.int32, device=device)

    depth, variance, flags = update_depth(keyframe, refframes, age,
                                          prior, variance, params)

    stats = flag_stats(flags)
    success = flags.cpu().numpy() == int(Flag.SUCCESS)
    err = np.abs(depth.cpu().numpy() - gt)[success]
    print("flag histogram:", {k: v for k, v in stats.items() if v})
    print(f"success fraction: {success.mean():.3f}")
    print(f"median |depth - gt| on success: {np.median(err):.4f}")

    if args.plot:
        from tadataka_torch.viz import plot_depth_dashboard
        plot_depth_dashboard(key.image, depth, variance, flags, gt_depth=gt)


if __name__ == "__main__":
    main()
