#!/usr/bin/env python3
"""VITAMIN-E VO of both packages on the CPU, on the frames that
``chip_smoke.py``'s ``vitamin_e`` phase drives on the card.

    JAX_PLATFORMS=cpu python tools/vitamin_e_vs_jax.py [--texture T]

The frames: the multi-plane scene at 480x640, focal 480, over 5 frames
of ``examples/vitamin_e_vo.py``'s trajectory (rotvec (0, 0.003 i, 0), t
(0.15 i, 0.01 i, 0), camera -> world), rendered by the port
(``dataset/synthetic.py``) with the ``--texture`` ("default", or "sharp":
the EuRoC export's high-frequency texture, which the ``feature`` phase
uses) and given as the same float32 images to both packages.  The VO:
``VitaminEVO(camera, fast_threshold=0.02, lambda_=0.5)``, the JAX
package's defaults otherwise (percentile 98, 2048 track keypoints, 512
FAST keypoints, patch 64).

Runs: the JAX package's ``VitaminEVO``; the port's on the CPU with the
JAX package's RANSAC draws.  Prints, per run and frame, the pose, the
tracks and the map's size; then the aligned (Umeyama) ATE as a share of
the true extent, and one JSON line of the JAX readings that
``chip_smoke.py`` gates on.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SHAPE = (480, 640)
FOCAL = 480.0
N_FRAMES = 5
VO_ARGS = dict(fast_threshold=0.02, lambda_=0.5)


def frames(texture="default", n=N_FRAMES, shape=SHAPE, focal=FOCAL):
    """The port's rendering: (frames with float32 CPU images, true camera
    positions (n, 3))."""
    import torch
    from tadataka_torch.core.pose import Pose
    from tadataka_torch.dataset.synthetic import (
        MULTI_PLANES, PlaneSceneDataset, _sharp_texture, default_texture)
    poses = [Pose.from_rotvec(torch.tensor([0.0, 0.003 * i, 0.0]),
                              torch.tensor([0.15 * i, 0.01 * i, 0.0]))
             for i in range(n)]
    ds = PlaneSceneDataset(len(poses), shape, (focal, focal), poses=poses,
                           planes=MULTI_PLANES,
                           texture=dict(default=default_texture,
                                        sharp=_sharp_texture)[texture])
    out = [ds[i] for i in range(n)]
    return out, np.stack([f.pose.t.numpy() for f in out])


def aligned_share(est, gt):
    """Aligned ATE over the true extent (both (n, 3))."""
    from tadataka_torch.metrics import absolute_trajectory_error
    est, gt = np.asarray(est, np.float64), np.asarray(gt, np.float64)
    return float(absolute_trajectory_error(est, gt)) / float(
        np.linalg.norm(gt[-1] - gt[0]))


def jax_uniform(site, shape):
    """The JAX package's RANSAC draws: PRNGKey(3939) at every site."""
    import jax
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(3939), shape))


def run(name, vo, images, gt):
    t0 = time.perf_counter()
    est = []
    for k, image in enumerate(images):
        pose = vo.estimate(image)
        t = None if pose is None else np.asarray(pose.t)
        print(f"[{name}] frame {k}: pose "
              f"{'LOST' if t is None else np.round(t, 4)}, tracks "
              f"{len(vo.keypoints[-1].ids)}, map {len(vo.points)}",
              flush=True)
        est.append(t)
    ok = all(t is not None for t in est)
    share = aligned_share(np.stack(est), gt) if ok else float("nan")
    print(f"[{name}] every frame a pose: {ok}; aligned ATE {share:.5f} of "
          f"the true extent; map {len(vo.points)} points; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return dict(poses=ok, ate_share=share, map_points=len(vo.points))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--texture", default="sharp",
                        choices=("default", "sharp"))
    args = parser.parse_args()
    from tadataka_torch.interop import camera_model_from_numpy
    from tadataka_torch.vo.vitamin_e import VitaminEVO
    from tadataka_tpu.camera import CameraModel, CameraParameters
    from tadataka_tpu.vo.vitamin_e import VitaminEVO as JVitaminEVO

    fs, gt = frames(args.texture)
    images = [f.image.numpy() for f in fs]
    offset = (SHAPE[1] / 2, SHAPE[0] / 2)
    jax_vo = JVitaminEVO(CameraModel.create(CameraParameters.create(
        (FOCAL, FOCAL), offset)), **VO_ARGS)
    readings = run("jax", jax_vo, images, gt)
    run("port, JAX draws", VitaminEVO(
        camera_model_from_numpy((FOCAL, FOCAL), offset), device="cpu",
        rng=jax_uniform, **VO_ARGS), images, gt)
    print(json.dumps(dict(texture=args.texture, **readings)))


if __name__ == "__main__":
    main()
