#!/usr/bin/env python3
"""EPnP on a benchmark cell's PnP samples, through several implementations.

    python3 tools/vitamin_e_epnp_witness.py capture [--frames 20]
        [--seed 1] [--device cuda] [--scale 1]
        [--out chiprun_out/epnp_samples.npz]
    [JAX_PLATFORMS=cpu] python3 tools/vitamin_e_epnp_witness.py compare
        [--samples chiprun_out/epnp_samples.npz]

``capture`` drives the cell's ``VitaminEVO`` (as the benchmark builds it)
over ``--frames`` frames of the cell's loop on ``--device`` (``--scale
4``: at a quarter of the size, BRIEF's patch 24, for the CPU) and keeps, on
every PnP frame, each RANSAC trial's 5 sampled world points and
normalized keypoints with the port's EPnP hypothesis for them.

``compare`` solves the same samples with the port's ``epnp_pose`` on the
CPU, the benchmark's plain reference
(``bench_port/reference/plain_geometry.py``) on the CPU in float32 and
float64, and either (on a machine with a card) the reference in float32
on the card or (without one) the JAX package's ``epnp_pose`` in float32
and in float64 (``jax_enable_x64``), and
prints for each pair the median and the 90th percentile over the trials
of the largest distance, in pixels (fx), between the 5 points projected
by the two hypotheses; and for each implementation the median of its
hypotheses' mean reprojection error on their own samples, in pixels;
then, frame by frame, the medians of the card's and the float32
reference's gaps to the float64 reference and of how much worse their
hypotheses fit their samples than its do.
The float64 solutions are the witness: a float32 implementation that
lies no farther from them than another float32 implementation does is
rounding, not a fault.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def capture(args):
    import torch
    from bench_port.harness import spec
    from bench_port.harness.traffic import load_mix, make_loop
    import tadataka_torch.pose_estimation.epnp as epnp

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(args.device)
    entry, config_entry = spec.cell(spec.load_benchmark(ROOT), args.workload)
    config = spec.load_config(config_entry, ROOT)
    if args.scale != 1:
        from bench_port.tests.small import small
        config = small(config, args.scale)
        config["app_args"] = dict(config["app_args"], patch_size=24)
    loop = make_loop(config, load_mix(entry["traffic"]), args.seed, device)
    system = spec.app_driver(config).System(config, loop, args.seed, device)
    kept = []
    real = epnp.epnp_pose

    def epnp_pose(points, keypoints):
        R, t = real(points, keypoints)
        kept.append(tuple(x.detach().cpu().numpy()
                          for x in (points, keypoints, R, t)))
        return R, t

    epnp.epnp_pose = epnp_pose
    frames = []
    try:
        for k in range(args.frames):
            n = len(kept)
            system.estimate(loop.frame(k))
            frames += [k] * (len(kept) - n)
    finally:
        epnp.epnp_pose = real
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    np.savez(args.out, frames=np.array(frames),
             points=np.stack([c[0] for c in kept]),
             keypoints=np.stack([c[1] for c in kept]),
             R=np.stack([c[2] for c in kept]),
             t=np.stack([c[3] for c in kept]),
             fx=config["camera"]["fx"],
             card=torch.cuda.get_device_name(0) if device.type == "cuda"
             else "cpu")
    print(json.dumps({"frames": frames, "kept": len(kept),
                      "out": args.out}))
    return 0


def _project(R, t, X):
    P = np.einsum("...ij,...nj->...ni", R, X) + t[..., None, :]
    return P[..., :2] / P[..., 2:]


def compare(args):
    import torch
    from bench_port.reference import plain_geometry as pg
    from tadataka_torch.pose_estimation.epnp import epnp_pose as port_epnp

    s = np.load(args.samples)
    fx = float(s["fx"])
    points = s["points"].reshape(-1, 5, 3)
    keypoints = s["keypoints"].reshape(-1, 5, 2)
    X64 = points.astype(np.float64)
    hyps = {"card": (s["R"].reshape(-1, 3, 3), s["t"].reshape(-1, 3))}
    R, t = port_epnp(torch.from_numpy(points), torch.from_numpy(keypoints))
    hyps["port_cpu"] = (R.numpy(), t.numpy())
    for dtype, name in ((torch.float32, "ref32"), (torch.float64, "ref64")):
        R, t = pg.epnp(torch.from_numpy(points).to(dtype),
                       torch.from_numpy(keypoints).to(dtype))
        hyps[name] = (R.numpy(), t.numpy())
    if torch.cuda.is_available():
        R, t = pg.epnp(torch.from_numpy(points).cuda(),
                       torch.from_numpy(keypoints).cuda())
        hyps["ref32_card"] = (R.cpu().numpy(), t.cpu().numpy())
    else:
        import jax
        import jax.numpy as jnp
        from tadataka_tpu.pose_estimation.epnp import epnp_pose as jax_epnp
        R, t = jax.jit(jax.vmap(jax_epnp))(jnp.asarray(points),
                                           jnp.asarray(keypoints))
        hyps["jax32"] = (np.asarray(R), np.asarray(t))
        jax.config.update("jax_enable_x64", True)
        R, t = jax.jit(jax.vmap(jax_epnp))(
            jnp.asarray(X64), jnp.asarray(keypoints, np.float64))
        hyps["jax64"] = (np.asarray(R), np.asarray(t))

    proj = {k: _project(R.astype(np.float64), t.astype(np.float64), X64)
            for k, (R, t) in hyps.items()}
    ok = np.all([np.isfinite(p).all((-1, -2)) for p in proj.values()], 0)
    out = {"card": str(s["card"]), "trials": int(len(points)),
           "finite": int(ok.sum()), "fit_px_median": {}, "gap_px": {}}
    for k, p in proj.items():
        fit = np.linalg.norm(p - keypoints, axis=-1).mean(-1) * fx
        out["fit_px_median"][k] = float(np.median(fit[ok]))
    names = list(proj)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            gap = np.linalg.norm(proj[a] - proj[b], axis=-1).max(-1)[ok] * fx
            out["gap_px"][f"{a}~{b}"] = [float(np.median(gap)),
                                         float(np.percentile(gap, 90))]
    # by frame: the medians of the card's and the float32 reference's
    # gaps to the float64 reference, and of their fits' excess over its
    frames = np.repeat(s["frames"], len(points) // len(s["frames"]))
    fit = {k: np.linalg.norm(p - keypoints, axis=-1).mean(-1) * fx
           for k, p in proj.items()}
    out["by_frame"] = {}
    for f in np.unique(frames):
        rows = ok & (frames == f)
        row = {}
        for k in ("card", "ref32"):
            gap = np.linalg.norm(proj[k] - proj["ref64"], axis=-1).max(-1)
            row[f"{k}~ref64_gap"] = float(np.median(gap[rows] * fx))
            row[f"{k}_fit_excess"] = float(np.median(
                fit[k][rows] - fit["ref64"][rows]))
        out["by_frame"][int(f)] = row
    print(json.dumps(out, indent=1))
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("mode", choices=("capture", "compare"))
    parser.add_argument("--workload", default="ve-fr1-forward")
    parser.add_argument("--frames", type=int, default=20)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--scale", type=int, default=1)
    parser.add_argument("--out", default="chiprun_out/epnp_samples.npz")
    parser.add_argument("--samples", default="chiprun_out/epnp_samples.npz")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    return capture(args) if args.mode == "capture" else compare(args)


if __name__ == "__main__":
    sys.exit(main())
