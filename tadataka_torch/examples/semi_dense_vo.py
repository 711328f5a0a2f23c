"""Semi-dense VO demo: DVO tracking + epipolar depth mapping (the port of
``examples/semi_dense_vo.py``).

    python -m tadataka_torch.examples.semi_dense_vo [--tum ROOT
        [--freiburg N] | --tsukuba] [--frames N] [--plot]
        [--device cuda|cpu]

Runs on the synthetic scene by default; ``--tum ROOT --freiburg N`` runs
on a TUM RGB-D sequence (every third frame), ``--tsukuba`` on the
NewTsukuba fixture frames, which this repository does not hold
(``NEW_TSUKUBA_FIXTURE``).  Prints one metrics record a frame (position,
SUCCESS share, median depth error where the frame has ground truth) and
their means.
"""

import argparse

import numpy as np
import torch

from tadataka_torch.apps import SemiDenseVO
from tadataka_torch.camera import CameraParameters
from tadataka_torch.core.pose import Pose
from tadataka_torch.device import resolve_device
from tadataka_torch.examples import NEW_TSUKUBA_FIXTURE, add_device_flag
from tadataka_torch.flags import Flag
from tadataka_torch.utils.observability import MetricsLogger, flag_stats
from tadataka_torch.vo.semi_dense import SemiDenseParams


def synthetic_frames(n, device, H=120, W=160, focal=120.0):
    from tadataka_torch.dataset.synthetic import multi_plane_scene
    poses = [Pose.from_rotvec(torch.tensor([0.0, 0.002 * i, 0.0]),
                              torch.tensor([0.18 * i, 0.01 * i, 0.01 * i]))
             for i in range(n)]
    ds = multi_plane_scene(n_frames=n, image_shape=(H, W),
                           focal_length=(focal, focal), poses=poses)
    cam = CameraParameters.create((focal, focal), (W / 2, H / 2),
                                  device=device)
    params = SemiDenseParams.create(2.0, 50.0, ref_step_size=0.002,
                                    min_gradient=0.01, device=device)
    vo = SemiDenseVO(cam, params=params, default_depth=8.0,
                     default_variance=1.0, uncertainty_bias=0.01,
                     depth_range=(2.0, 50.0), n_coarse_to_fine=4,
                     device=device)
    vo.initial_pose_fn = lambda i0, i1: ds[1].pose.inv() * ds[0].pose
    return vo, [ds[i] for i in range(n)]


def tsukuba_frames(n, device):
    """NewTsukuba fixture frames (left camera).  The monocular scale is
    fixed at bootstrap as the JAX example fixes it: the essential-matrix
    pose rescaled to the ground-truth first-step length."""
    from tadataka_torch.dataset.new_tsukuba import NewTsukubaDataset
    from tadataka_torch.features.brief import extract_features
    from tadataka_torch.features.matching import Matcher
    from tadataka_torch.pose_estimation import estimate_pose_change

    ds = NewTsukubaDataset(NEW_TSUKUBA_FIXTURE)
    frames = [ds[i][0] for i in range(min(n, len(ds)))]
    p = frames[0].camera_model.camera_parameters
    cam = CameraParameters.create(p.focal_length, p.offset, device=device)
    scale = float(torch.linalg.norm(frames[1].pose.t - frames[0].pose.t))
    cm = frames[0].camera_model.to(device)
    matcher = Matcher()

    def bootstrap(image0, image1):
        f0 = extract_features(image0, threshold=20.0 / 255.0,
                              max_keypoints=1024)
        f1 = extract_features(image1, threshold=20.0 / 255.0,
                              max_keypoints=1024)
        m = matcher(f0, f1)
        idx = m.indices[m.mask]
        pose10 = estimate_pose_change(cm.normalize(f0.keypoints[idx[:, 0]]),
                                      cm.normalize(f1.keypoints[idx[:, 1]]))
        return Pose(pose10.R, scale * pose10.t)

    # frame-to-frame baseline is ~1.2 cm, so epipolar segments span only
    # a few pixels: sample at ~0.6 px (step 0.001 normalized) and relax
    # the gradient gate accordingly
    params = SemiDenseParams.create(60.0, 1000.0, geo_coeff=0.01,
                                    photo_coeff=0.01, ref_step_size=0.001,
                                    min_gradient=0.05, device=device)
    vo = SemiDenseVO(cam, params=params, depth_range=(60.0, 1000.0),
                     default_depth=200.0, default_variance=0.01,
                     uncertainty_bias=1e-4, initial_pose_fn=bootstrap,
                     device=device)
    return vo, frames


def tum_frames(root, freiburg, n, device):
    from tadataka_torch.dataset import TumRgbdDataset
    ds = TumRgbdDataset(root, which_freiburg=freiburg)
    frames = [ds[i] for i in range(0, min(n * 3, len(ds)), 3)]
    p = frames[0].camera_model.camera_parameters
    cam = CameraParameters.create(p.focal_length, p.offset, device=device)
    vo = SemiDenseVO(cam, depth_range=(0.3, 10.0), default_depth=2.0,
                     default_variance=1.0, uncertainty_bias=0.05,
                     device=device)
    return vo, frames


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--tum", default=None)
    parser.add_argument("--tsukuba", action="store_true",
                        help="run on the real NewTsukuba fixture frames")
    parser.add_argument("--freiburg", type=int, default=1)
    parser.add_argument("--frames", type=int, default=6)
    parser.add_argument("--plot", action="store_true")
    add_device_flag(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    if args.tum:
        vo, frames = tum_frames(args.tum, args.freiburg, args.frames, device)
    elif args.tsukuba:
        vo, frames = tsukuba_frames(args.frames, device)
    else:
        vo, frames = synthetic_frames(args.frames, device)

    logger = MetricsLogger()
    state = None
    for i, frame in enumerate(frames):
        state = vo.estimate(frame)
        metrics = {"t": state.pose_wc.t.cpu().tolist()}
        if state.flag_map is not None:
            stats = flag_stats(state.flag_map)
            metrics["success_frac"] = (
                stats["SUCCESS"] / state.flag_map.numel())
            if frame.depth_map is not None:
                flags = state.flag_map.cpu().numpy()
                success = flags == int(Flag.SUCCESS)
                err = np.abs(state.depth_map.cpu().numpy()
                             - np.asarray(frame.depth_map))[success]
                if err.size:
                    metrics["median_depth_err"] = float(np.median(err))
        rec = logger.log_frame(i, **metrics)
        print(rec)

    print("summary:", logger.summary())

    if args.plot and state is not None:
        from tadataka_torch.viz import plot_depth_dashboard
        plot_depth_dashboard(frames[-1].image, state.depth_map,
                             state.variance_map, state.flag_map,
                             gt_depth=frames[-1].depth_map)


if __name__ == "__main__":
    main()
