#!/usr/bin/env python3
"""The DVO trajectory of both packages on the CPU, on the TUM RGB-D
scene that ``chip_smoke.py``'s ``dvo`` phase drives on the card.

    JAX_PLATFORMS=cpu python tools/dvo_vs_jax.py [--frames 8]

Exports the freiburg1 scene (``export_tum_scene``, 480x640, RadTan) with
each package's exporter into a temporary directory, reads each export
with each package's TUM loader, and runs ``DvoTrajectory(weights=
"huber")`` with its defaults (5 levels, 20 iterations; the JAX app on
its gather path) over the frames.  Prints, per run, the aligned
(Umeyama) and unaligned ATE and the trajectory's extent, then one JSON
line.  ``chip_smoke.py`` holds the card's ATE to the JAX ATE on the
port's export, within a margin.  About half a minute.
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def jax_run(root, n):
    from tadataka_tpu.apps import DvoTrajectory
    from tadataka_tpu.dataset.tum_rgbd import TumRgbdDataset
    ds = TumRgbdDataset(root, which_freiburg=1)
    frames = [ds[i] for i in range(n)]
    vo = DvoTrajectory(ds.camera_model, weights="huber")
    vo.estimator.sample_budget = 0
    for frame in frames:
        vo.estimate(frame)
    return vo.positions(), np.stack([np.asarray(f.pose.t) for f in frames])


def port_run(root, n):
    from tadataka_torch.apps import DvoTrajectory
    from tadataka_torch.dataset import TumRgbdDataset
    ds = TumRgbdDataset(root, which_freiburg=1)
    frames = [ds[i] for i in range(n)]
    vo = DvoTrajectory(ds.camera_model, weights="huber", device="cpu")
    for frame in frames:
        vo.estimate(frame)
    return vo.positions(), np.stack([f.pose.t.numpy() for f in frames])


def ates(est, gt):
    from tadataka_torch.metrics import absolute_trajectory_error
    return (float(absolute_trajectory_error(est, gt)),
            float(absolute_trajectory_error(est, gt, align=False)),
            float(np.linalg.norm(gt[-1] - gt[0])))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--frames", type=int, default=8)
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    from tadataka_tpu.dataset.synthetic import export_tum_scene as jexport
    from tadataka_torch.dataset import export_tum_scene
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        roots = {"jax export": Path(tmp, "jax"),
                 "port export": Path(tmp, "port")}
        jexport(roots["jax export"], n_frames=args.frames,
                image_shape=(480, 640))
        export_tum_scene(roots["port export"], n_frames=args.frames,
                         image_shape=(480, 640))
        for export, root in roots.items():
            for package, run in (("jax", jax_run), ("port", port_run)):
                t0 = time.perf_counter()
                est, gt = run(root, args.frames)
                aligned, unaligned, extent = ates(est, gt)
                key = f"{package} on {export}"
                results[key] = dict(ate_aligned_m=aligned,
                                    ate_unaligned_m=unaligned,
                                    extent_m=extent,
                                    positions=est.tolist())
                print(f"{key}: ATE aligned {aligned * 100:.5f} cm, "
                      f"unaligned {unaligned * 100:.5f} cm, extent "
                      f"{extent:.4f} m ({time.perf_counter() - t0:.1f} s)",
                      flush=True)
    d = np.abs(np.array(results["port on port export"]["positions"])
               - np.array(results["jax on port export"]["positions"])).max()
    print(f"port vs jax positions on the port export: max |d| {d:.3g} m")
    print(json.dumps(dict(frames=args.frames, shape=[480, 640],
                          results={k: {m: v for m, v in r.items()
                                       if m != "positions"}
                                   for k, r in results.items()},
                          port_vs_jax_max_m=d)))


if __name__ == "__main__":
    main()
