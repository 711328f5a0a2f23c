#!/usr/bin/env python3
"""VitaminEVO over loops of a benchmark cell's frames, frame by frame.

    python3 tools/vitamin_e_loops.py [--workload ve-fr1-forward]
        [--frames 306] [--seed 1] [--device cuda|cpu] [--scale 1]
        [--patch-size N] [--out FILE]

Renders the cell's loop from the seed (``bench_port/harness/traffic``),
builds the app as the benchmark does (``bench_port/apps/vitamin_e.py``)
and hands it ``--frames`` frames, replaying the loop.  For each frame it
records the time to the pose on the host, whether the app lost track
(``estimate`` returned None), the tracks carried in, the keypoints
spawned, the points written and the PnP inputs (the app's own counters),
and, on every tenth frame, the cost of the driver's ``snapshot()``
(the frame after it then runs as a sampled one, its probes captured).
It also counts the curvature's pixels above the configuration's
percentile on the first frame, before the 2048 cap.  ``--scale 4``
renders at a quarter of the size (intrinsics too), for the CPU.
Prints one JSON summary line last; ``--out`` keeps every frame's row.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", default="ve-fr1-forward")
    parser.add_argument("--frames", type=int, default=306)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--scale", type=int, default=1)
    parser.add_argument("--patch-size", type=int, default=None)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    from bench_port.harness import spec
    from bench_port.harness.traffic import load_mix, make_loop
    from bench_port.reference.common import rgb2gray
    from bench_port.tests.small import small
    from tadataka_torch.features.curvature import (
        compute_image_curvature, percentile_of)
    from tadataka_torch.utils.timing import trace

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(args.device)
    bench = spec.load_benchmark(ROOT)
    entry, config_entry = spec.cell(bench, args.workload)
    config = spec.load_config(config_entry, ROOT)
    if args.scale != 1:
        config = small(config, args.scale)
    if args.patch_size is not None:
        config["app_args"] = dict(config["app_args"],
                                  patch_size=args.patch_size)
    loop = make_loop(config, load_mix(entry["traffic"]), args.seed, device)
    system = spec.app_driver(config).System(config, loop, args.seed, device)

    image0 = torch.from_numpy(rgb2gray(loop.frame(0).image)).to(device)
    curv = compute_image_curvature(image0)
    above = int((curv > percentile_of(
        curv, config["app_args"]["percentile"])).sum())

    rows, lost = [], []
    for k in range(args.frames):
        snapshot_ms = None
        if k % 10 == 0:
            if device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            system.snapshot()
            snapshot_ms = (time.perf_counter() - t0) * 1e3
        with trace() as t:
            t0 = time.perf_counter()
            out = system.estimate(loop.frame(k))
            ms = (time.perf_counter() - t0) * 1e3
        counts = {name: sum(v.values()) for name, v in t.counts.items()
                  if name.startswith("ve.")}
        if out is None:
            lost.append(k)
        rows.append({"frame": k, "ms": ms, "lost": out is None,
                     "snapshot_ms": snapshot_ms, **counts,
                     "map": len(system.vo.points)})
    ms = np.array([r["ms"] for r in rows[3:]])
    snaps = [r["snapshot_ms"] for r in rows if r["snapshot_ms"] is not None
             and r["frame"] >= 3]

    def spread(name):
        v = [r.get(name, 0) for r in rows[2:]]
        return [int(min(v)), float(np.median(v)), int(max(v))]

    summary = {
        "workload": args.workload, "device": str(device),
        "card": torch.cuda.get_device_name(0) if device.type == "cuda"
        else "cpu", "shape": config["image_shape"], "frames": len(rows),
        "lost": lost, "above_percentile_frame0": above,
        "tracks_frame0": len(system.vo.keypoints[0].ids),
        "ms_median": float(np.median(ms)), "ms_p95":
        float(np.percentile(ms, 95)), "ms_max": float(ms.max()),
        "snapshot_ms_median": float(np.median(snaps)) if snaps else None,
        # a frame after a snapshot runs as a sampled one: its probes
        # captured (``apps/vitamin_e.py``)
        "sampled_ms_median": float(np.median(
            [r["ms"] for r in rows[3:] if r["snapshot_ms"] is not None])),
        "unsampled_ms_median": float(np.median(
            [r["ms"] for r in rows[3:] if r["snapshot_ms"] is None])),
        "snapshot_ms_max": float(max(snaps)) if snaps else None,
        "tracked": spread("ve.tracked"), "spawned": spread("ve.spawned"),
        "pnp_points": spread("ve.pnp_points"),
        "triangulated": spread("ve.triangulated"),
        "map_final": rows[-1]["map"],
    }
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"summary": summary,
                                              "rows": rows}))
    print(json.dumps(summary), flush=True)
    return 1 if lost else 0


if __name__ == "__main__":
    sys.exit(main())
