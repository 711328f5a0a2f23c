#!/usr/bin/env python3
"""The feature-based VO of both packages on the CPU, on the two
configurations that ``chip_smoke.py``'s ``feature`` phase drives on the
card.

    JAX_PLATFORMS=cpu python tools/feature_vs_jax.py [--config C] [--seeds N]

``--config``: ``euroc``, ``synthetic`` or ``both`` (the default).

- ``euroc``: the port's ``export_euroc_scene`` at EuRoC's 480x752, 5
  frames, read back by each package's EuRoC loader, the left images as
  float32 / 255, through ``FeatureBasedVO(fast_threshold=10/255,
  min_matches=24, max_keypoints=512)`` (``bench.py``'s ``bench_euroc``
  setting).
- ``synthetic``: the multi-plane scene at 480x640, focal 480, over 8
  frames of ``tests/vo/test_feature_based.py``'s trajectory, rendered by
  the port with the EuRoC export's high-frequency texture (the default
  texture holds no FAST corner at 20/255 at this size), the same images
  to both packages, through ``FeatureBasedVO(fast_threshold=20/255,
  min_matches=40, max_keypoints=1024)`` (``bench_feature_vo``'s
  setting).

Runs: the JAX app; the port with the JAX package's RANSAC draws
injected; the port with its own generator (seeded 3939, and with
``--seeds`` more seeds).  Prints, per run, the frames that returned a
pose, the aligned (Umeyama) ATE as a share of the ground truth's extent
and the cosine between the first estimated motion and the true one in
the first camera's frame (the VO's world), the same cosine for the
whole path (last position less the first), then one JSON line.
``chip_smoke.py`` gates the card on the JAX readings.  A few minutes
(the JAX app compiles its programs per capacity bucket).
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CONFIGS = {
    "euroc": dict(vo=dict(fast_threshold=10.0 / 255.0, min_matches=24,
                          max_keypoints=512),
                  shape=(480, 752), frames=5),
    "synthetic": dict(vo=dict(fast_threshold=20.0 / 255.0, min_matches=40,
                              max_keypoints=1024),
                      shape=(480, 640), focal=480.0, frames=8),
}


def trajectory(n):
    """tests/vo/test_feature_based.py's trajectory: rotvec (0, 0.002 i,
    0), t (0.25 i, 0.01 i, 0.02 i), camera -> world."""
    return [(np.array([0.0, 0.002 * i, 0.0], np.float32),
             np.array([0.25 * i, 0.01 * i, 0.02 * i], np.float32))
            for i in range(n)]


def jax_uniform(site, shape):
    """The JAX package's draws at ``site`` (see features/ransac.py)."""
    import jax
    key = jax.random.PRNGKey(3939)
    if isinstance(site, tuple) and site[0] == "match":
        key = jax.random.split(key, site[2])[site[1]]
    return np.asarray(jax.random.uniform(key, shape))


def readings(est, gt, R0):
    """(aligned ATE / extent, cos of the first motion, cos of the whole
    path's motion, last position less first) over the frames that
    returned a pose; ``R0`` is the first camera's rotation (camera ->
    world), which takes the true motion into the VO's world."""
    from tadataka_torch.metrics import absolute_trajectory_error
    if len(est) < 2:
        return float("nan"), float("nan"), float("nan")
    est, gt = np.asarray(est, np.float64), np.asarray(gt, np.float64)
    extent = float(np.linalg.norm(gt[-1] - gt[0]))
    ate = float(absolute_trajectory_error(est, gt))
    def cos(k):
        d_est = est[k] - est[0]
        d_gt = np.asarray(R0, np.float64).T @ (gt[k] - gt[0])
        return float(d_est @ d_gt
                     / (np.linalg.norm(d_est) * np.linalg.norm(d_gt)))
    return ate / extent, cos(1), cos(-1)


def frames_of(config, root, package):
    """The configuration's frames as (image float32 array, camera model,
    true position, true rotation) in ``package``'s types."""
    c = CONFIGS[config]
    if config == "euroc":
        if package == "jax":
            from tadataka_tpu.dataset.euroc import EurocDataset
        else:
            from tadataka_torch.dataset import EurocDataset
        ds = EurocDataset(root)
        out = []
        for i in range(len(ds)):
            left = ds[i][0]
            out.append((np.asarray(left.image, np.float32) / 255.0,
                        left.camera_model, np.asarray(left.pose.t),
                        np.asarray(left.pose.R)))
        return out
    import torch
    from tadataka_torch.core.pose import Pose
    from tadataka_torch.dataset.synthetic import (
        MULTI_PLANES, PlaneSceneDataset, _sharp_texture)
    H, W = c["shape"]
    f = c["focal"]
    poses = [Pose.from_rotvec(torch.from_numpy(r), torch.from_numpy(t))
             for r, t in trajectory(c["frames"])]
    ds = PlaneSceneDataset(len(poses), (H, W), (f, f), poses=poses,
                           planes=MULTI_PLANES,
                           texture=_sharp_texture)
    camera_model = ds.camera_model
    if package == "jax":
        from tadataka_tpu.camera import CameraModel, CameraParameters
        camera_model = CameraModel.create(CameraParameters.create(
            (f, f), (W / 2.0, H / 2.0)))
    out = []
    for i in range(len(ds)):
        frame = ds[i]
        out.append((frame.image.numpy(), camera_model,
                    frame.pose.t.numpy(), frame.pose.R.numpy()))
    return out


class _Frame:
    def __init__(self, image, camera_model):
        self.image, self.camera_model = image, camera_model


def run(config, frames, vo):
    est, gt, ms = [], [], []
    for image, camera_model, t_true, _ in frames:
        t0 = time.perf_counter()
        pose = vo.estimate(_Frame(image, camera_model))
        ms.append((time.perf_counter() - t0) * 1e3)
        if pose is not None:
            est.append(np.asarray(pose.t))
            gt.append(t_true)
    share, cos, path_cos = readings(est, gt, frames[0][3])
    return dict(frames=f"{len(est)}/{len(frames)}", ate_share=share, cos=cos,
                path_cos=path_cos,
                points=len(vo.point_dict), ms=[round(m, 1) for m in ms])


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="both",
                        choices=["euroc", "synthetic", "both"])
    parser.add_argument("--seeds", type=int, default=0,
                        help="extra generator seeds for the port's own runs")
    args = parser.parse_args()
    configs = (["euroc", "synthetic"] if args.config == "both"
               else [args.config])
    from tadataka_tpu.vo.feature_based import FeatureBasedVO as JFeatureBasedVO
    from tadataka_torch.dataset import export_euroc_scene
    from tadataka_torch.features.ransac import default_generator
    from tadataka_torch.vo.feature_based import FeatureBasedVO
    result = {}
    with tempfile.TemporaryDirectory() as root:
        for config in configs:
            c = CONFIGS[config]
            if config == "euroc":
                export_euroc_scene(root, n_frames=c["frames"],
                                   image_shape=c["shape"])
            out = {}
            out["jax"] = run(config, frames_of(config, root, "jax"),
                             JFeatureBasedVO(**c["vo"]))
            port_frames = frames_of(config, root, "torch")
            out["port_jax_draws"] = run(config, port_frames, FeatureBasedVO(
                device="cpu", rng=jax_uniform, **c["vo"]))
            for seed in [3939] + list(range(args.seeds)):
                out[f"port_seed{seed}"] = run(config, port_frames,
                                              FeatureBasedVO(
                    device="cpu", rng=default_generator("cpu", seed),
                    **c["vo"]))
            for name, r in out.items():
                print(f"[{config}] {name}: {r['frames']} frames with a pose, "
                      f"ATE {r['ate_share']:.5f} of the extent, first-motion "
                      f"cos {r['cos']:.5f}, whole-path cos "
                      f"{r['path_cos']:.5f}, {r['points']} points; ms/frame "
                      f"{r['ms']}", flush=True)
            result[config] = out
    print(json.dumps(result))


if __name__ == "__main__":
    main()
