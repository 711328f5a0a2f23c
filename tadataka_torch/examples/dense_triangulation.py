"""Dense two-view triangulation three ways: sparse features, dense
curvature-extrema matching and dense affine-flow tracking (the port of
``examples/dense_triangulation.py``).

    python -m tadataka_torch.examples.dense_triangulation [--plot]
        [--device cuda|cpu]

Reads frames 0 and 4 of the NewTsukuba fixture (``NEW_TSUKUBA_FIXTURE``,
which this repository does not hold) with their true poses, as the JAX
example does; prints each method's point count and median distance.
"""

import argparse

import numpy as np
import torch

from tadataka_torch.core.image_range import is_in_image_range
from tadataka_torch.core.pose import Pose
from tadataka_torch.core.triangulation import (
    two_view_triangulation, compute_depth_mask)
from tadataka_torch.dataset.image_io import rgb2gray
from tadataka_torch.device import resolve_device, upload
from tadataka_torch.examples import NEW_TSUKUBA_FIXTURE, add_device_flag
from tadataka_torch.features import Matcher
from tadataka_torch.features.brief import brief_descriptors, extract_features
from tadataka_torch.features.curvature import (
    compute_image_curvature, extract_curvature_extrema)
from tadataka_torch.features.detector import Features
from tadataka_torch.features.extrema_tracker import ExtremaTracker
from tadataka_torch.features.flow import estimate_affine_transform

FAST_THRESHOLD = 20.0 / 255.0


def extract_dense_features(image):
    """BRIEF descriptors at curvature extrema."""
    kps, mask = extract_curvature_extrema(image, percentile=95.0,
                                          max_keypoints=2048)
    desc, dmask = brief_descriptors(image, kps, mask)
    return Features(kps, desc, mask & dmask)


def matched_normalized(camera_model, feats0, feats1, matcher):
    """The matches' normalized coordinates in each view, and their pixel
    keypoints (host arrays)."""
    m = matcher(feats0, feats1)
    idx = m.indices[m.mask].cpu().numpy()
    kp0 = feats0.keypoints.cpu().numpy()[idx[:, 0]]
    kp1 = feats1.keypoints.cpu().numpy()[idx[:, 1]]
    device = feats0.keypoints.device
    return (camera_model.normalize(upload(kp0, device)),
            camera_model.normalize(upload(kp1, device)), kp0, kp1)


def triangulate(pose0, pose1, n0, n1):
    """Points (host) of the matches in front of both cameras (pose0,
    pose1: camera -> world), and that mask."""
    points, depths = two_view_triangulation(pose0.inv(), pose1.inv(), n0, n1)
    ok = compute_depth_mask(depths).cpu().numpy()
    return points.cpu().numpy()[ok], ok


def report(name, points):
    print(f"{name}: {len(points)} points, "
          f"median depth {np.median(np.linalg.norm(points, axis=1)):.1f}")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--plot", action="store_true")
    add_device_flag(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    from tadataka_torch.dataset.new_tsukuba import NewTsukubaDataset
    ds = NewTsukubaDataset(NEW_TSUKUBA_FIXTURE)
    frame0, _ = ds[0]
    frame1, _ = ds[4]
    image0 = upload(rgb2gray(np.asarray(frame0.image)), device,
                    torch.float32)
    image1 = upload(rgb2gray(np.asarray(frame1.image)), device,
                    torch.float32)
    cm = ds.camera_model.to(device)
    pose0, pose1 = (Pose(f.pose.R.to(device), f.pose.t.to(device))
                    for f in (frame0, frame1))
    matcher = Matcher()

    # 1. sparse: FAST + BRIEF matches
    f0 = extract_features(image0, threshold=FAST_THRESHOLD,
                          max_keypoints=1024)
    f1 = extract_features(image1, threshold=FAST_THRESHOLD,
                          max_keypoints=1024)
    n0, n1, _, _ = matched_normalized(cm, f0, f1, matcher)
    sparse_points, _ = triangulate(pose0, pose1, n0, n1)
    report("sparse feature triangulation", sparse_points)

    # 2. dense match: BRIEF at curvature extrema
    d0 = extract_dense_features(image0)
    d1 = extract_dense_features(image1)
    n0, n1, kp0, kp1 = matched_normalized(cm, d0, d1, matcher)
    dense_points, _ = triangulate(pose0, pose1, n0, n1)
    report("dense match triangulation", dense_points)

    # 3. dense track: affine flow + extrema hill climb
    flow01 = estimate_affine_transform(upload(kp0, device),
                                       upload(kp1, device))
    all0, mask0 = extract_curvature_extrema(image0, percentile=95.0,
                                            max_keypoints=4096)
    all0 = all0[mask0]
    predicted = flow01(all0)
    inside = is_in_image_range(predicted, tuple(image1.shape))
    tracker = ExtremaTracker(compute_image_curvature(image1), lambda_=10.0)
    tracked = tracker.optimize(predicted[inside])
    track_points, _ = triangulate(pose0, pose1, cm.normalize(all0[inside]),
                                  cm.normalize(tracked))
    report("dense track triangulation", track_points)

    if args.plot:
        from tadataka_torch.viz import plot_map
        plot_map([frame0.pose, frame1.pose], track_points)


if __name__ == "__main__":
    main()
