#!/usr/bin/env python3
"""Profile a slice of chip_smoke.py on one CUDA card.

    python3 tools/profile_slice.py [--path tent|rect|scatter|dvo|pipelined]
                                   [--profiled 3]

Drives the sequence of one of chip_smoke.py's 480x640 phases on the
card, with the same trajectory, parameters and bootstrap: through
``SemiDenseVO.estimate``, ``tent`` phase 5 (12 frames, the homography
sweep), ``rect`` the rect phase (10 frames of the lateral trajectory,
the rectified sweep), ``scatter`` the scatter phase (5 frames,
``depth_update="scatter"``); through ``DvoTrajectory.estimate``,
``dvo`` the dvo phase (the 8-frame freiburg1 TUM scene, exported and
read back); through ``PipelinedSemiDenseVO.estimate``, ``pipelined``
phase 5's frames as the pipelined phase drives them (tracker and mapper
on two streams).  It records the last ``--profiled`` frames with
``torch.profiler``; for ``pipelined`` it also prints each stream's busy
time and the time both streams ran kernels at once, from the kernels'
stream ids in the profiler's trace.
Prints, per profiled frame: the wall time, the device-busy time (the
union of kernel intervals), the kernels launched and the DVO
Gauss-Newton iterations (``aten::linalg_solve`` calls); then the
kernels that took the most device time.  The profiler slows the host,
so its wall times are longer than an unprofiled run's.
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from bench_port.harness.trace import union_length as busy_us  # noqa: E402
from tadataka_torch.dataset import multi_plane_scene  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--path", choices=("tent", "rect", "scatter", "dvo",
                                           "pipelined"), default="tent")
    parser.add_argument("--profiled", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_slice: no CUDA device")
    with tempfile.TemporaryDirectory() as tum_root:
        if args.path == "dvo":
            frames, vo = dvo_sequence(tum_root)
        elif args.path == "pipelined":
            frames, vo = pipelined_sequence()
        else:
            frames, vo = slice_sequence(args.path)
        profile_frames(args, frames, vo)


def dvo_sequence(tum_root):
    from tadataka_torch.apps import DvoTrajectory
    from tadataka_torch.dataset import TumRgbdDataset, export_tum_scene
    export_tum_scene(tum_root, n_frames=chip_smoke.N_DVO_FRAMES,
                     image_shape=chip_smoke.VGA)
    ds = TumRgbdDataset(tum_root, which_freiburg=1)
    frames = [ds[i] for i in range(len(ds))]
    return frames, DvoTrajectory(ds.camera_model, weights="huber")


def pipelined_sequence():
    n = chip_smoke.N_FRAMES
    ds = multi_plane_scene(n, chip_smoke.VGA,
                           (chip_smoke.VGA_FOCAL, chip_smoke.VGA_FOCAL),
                           chip_smoke.trajectory(n))
    frames = [ds[i] for i in range(n)]
    vo = chip_smoke.make_pipelined(chip_smoke.VGA, chip_smoke.VGA_FOCAL,
                                   "cuda")
    vo.initial_pose_fn = lambda image0, image1: (
        frames[1].pose.inv() * frames[0].pose)
    return frames, vo


def stream_overlap(prof):
    """Per CUDA stream, the busy time (union of its kernels' intervals),
    and the time kernels of two streams ran at once, in us, from the
    stream ids of the kernels in the profiler's trace."""
    with tempfile.TemporaryDirectory() as d:
        path = Path(d, "trace.json")
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
    by_stream, mapper = {}, set()
    for e in trace.get("traceEvents", []):
        if str(e.get("cat", "")).lower() == "kernel" and "dur" in e:
            stream = e.get("args", {}).get("stream")
            by_stream.setdefault(stream, []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
            if "ssd_search" in e.get("name", ""):
                mapper.add(stream)
    busy = {f"{s}{' (mapper: ssd_search)' if s in mapper else ''}":
            busy_us(v) for s, v in by_stream.items()}
    union = busy_us([iv for v in by_stream.values() for iv in v])
    return busy, sum(busy.values()) - union


def slice_sequence(path):
    overrides, motion = {}, {}
    n = chip_smoke.N_FRAMES
    if path == "rect":
        n, motion = chip_smoke.N_RECT_FRAMES, chip_smoke.LATERAL
    elif path == "scatter":
        n, overrides = chip_smoke.N_SCATTER_FRAMES, dict(depth_update="scatter")
    ds = multi_plane_scene(n, chip_smoke.VGA,
                           (chip_smoke.VGA_FOCAL, chip_smoke.VGA_FOCAL),
                           chip_smoke.trajectory(n, **motion))
    frames = [ds[i] for i in range(n)]
    vo = chip_smoke.make_vo(chip_smoke.VGA, chip_smoke.VGA_FOCAL, "cuda",
                            **overrides)
    if path == "rect":
        vo.pose_drain_interval = n      # as chip_smoke.phase_rect
    vo.initial_pose_fn = lambda image0, image1: (
        frames[1].pose.inv() * frames[0].pose)
    return frames, vo


def profile_frames(args, frames, vo):
    n = len(frames)
    first = n - args.profiled
    for frame in frames[:first]:
        vo.estimate(frame)
    torch.cuda.synchronize()

    walls = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for k in range(first, n):
            t0 = time.perf_counter()
            with record_function(f"frame {k}"):
                vo.estimate(frames[k])
                torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.name.startswith("frame ")]
    solves = [e.time_range.start for e in events
              if e.name == "aten::linalg_solve"]
    spans = {e.name: e.time_range for e in events
             if e.name.startswith("frame ")}
    for k, wall in zip(range(first, n), walls):
        span = spans[f"frame {k}"]
        mine = [e for e in kernels
                if span.start <= e.time_range.start < span.end]
        busy = busy_us((e.time_range.start, e.time_range.end) for e in mine)
        its = sum(span.start <= s < span.end for s in solves)
        print(f"[profile] frame {k}: wall {wall * 1e3:.2f} ms, device busy "
              f"{busy / 1e3:.2f} ms, {len(mine)} kernels, {its} DVO "
              "iterations", flush=True)
    total_busy = busy_us((e.time_range.start, e.time_range.end)
                         for e in kernels)
    wall = sum(walls) * 1e6
    print(f"[profile] {args.path}, frames {first}-{n - 1}: {len(kernels)} "
          f"kernels, device busy {total_busy / 1e3:.2f} ms of "
          f"{wall / 1e3:.2f} ms "
          f"wall ({100 * total_busy / wall:.1f}%), {len(solves)} DVO "
          "iterations")
    by_name = {}
    for e in kernels:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.end - e.time_range.start, c + 1)
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"[profile] {t / 1e3:9.3f} ms {c:6d}x  {name[:100]}")
    if args.path == "pipelined":
        busy, both = stream_overlap(prof)
        print("[profile] pipelined, busy per stream: " + ", ".join(
            f"stream {s} {t / 1e3:.2f} ms" for s, t in sorted(
                busy.items(), key=lambda kv: str(kv[0])))
              + f"; two streams at once {both / 1e3:.3f} ms of "
              f"{wall / 1e3:.2f} ms wall", flush=True)


if __name__ == "__main__":
    main()
