"""One run of one cell: set-up, warm-up, the measured window, the
traced readings, the check, and the result line.

The loop is closed: each frame is handed to the app's ``estimate`` as
the camera's driver delivers it (a host array), and timed until its
camera pose is in host memory; the next frame follows at once.  The
window opens after the app's warm-up frames (its ``warm_frames``: the
bootstrap, the history filled and a few frames at full size, so every
shape the window runs has run), runs frames until ``seconds`` have
passed, and closes with a full synchronization after the last frame it
started.  A frame whose ``estimate`` raises, or whose pose or maps hold
a non-finite value (reduced on the device and read once, when the
window has closed), has failed.

A traced run (``--trace 1``) reads the window on stretches of frames of
their own, so that no reading disturbs another: the profiler
(``PROFILED``, with the harness's synchronized spans and the program's
spans as its annotations), host-sync counting (``SYNC_COUNTED``) and the
program's own trace (``PROGRAM_TRACED``: ``tadataka_torch``'s
``utils/timing.trace()``, with neither the harness's spans, nor the
profiler, nor sync counting, so the program's self times are the
host's alone).  The harness's spans time the other frames.  An
untraced run opens none of them.
"""

import json
import subprocess
import sys
import time
from contextlib import ExitStack

import numpy as np
import torch

from bench_port.harness import spec
from bench_port.harness.record import Recorder, copy_of
from bench_port.harness.traffic import load_mix, make_loop

FORBIDDEN = ("jax", "jaxlib", "flax", "tadataka_tpu")
CHECK_FRAMES = 12        # window frames sampled for the check
START_FRAMES = 3         # the first frames, always checked
PROFILED = (2, 5)        # window frames 2..6 are profiled in a traced run
SYNC_COUNTED = (8, 5)    # window frames 8..12 count host syncs (traced)
PROGRAM_TRACED = (14, 10)  # window frames 14..23 run in the program's trace


def loaded_forbidden():
    """Top-level names of loaded modules that are JAX or the JAX
    package, compared whole."""
    names = {m.split(".")[0] for m in sys.modules}
    return sorted(names & set(FORBIDDEN))


def device_summary(device, chips):
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}


def power_limit():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


class Reservoir:
    """A uniform sample of ``size`` window frames, drawn from the seed
    before each frame runs (Algorithm R), so only sampled frames are
    captured."""

    def __init__(self, seed, size):
        self.rng = np.random.default_rng([seed, 0x5EED])
        self.size = size
        self.seen = 0
        self.kept = []

    def offer(self, frame):
        """(capture this frame?, the frame it displaces or None)."""
        i = self.seen
        self.seen += 1
        if i < self.size:
            self.kept.append(frame)
            return True, None
        j = int(self.rng.integers(0, i + 1))
        if j < self.size:
            out, self.kept[j] = self.kept[j], frame
            return True, out
        return False, None


def within(stretch, w):
    """Whether window frame ``w`` lies in ``stretch`` (first, count)."""
    return stretch[0] <= w < stretch[0] + stretch[1]


def program_trace():
    """The program's own trace block (``tadataka_torch.utils.timing``),
    imported only where a traced run opens it."""
    from tadataka_torch.utils import timing
    return timing.trace()


def log(err, message):
    print(f"[bench_port] {message}", file=err, flush=True)


def run(workload, seed, seconds, trace, device="cuda", t_start=None,
        root=spec.ROOT, config_override=None, control=False,
        out=sys.stdout, err=sys.stderr):
    """Run one cell and print its result line; returns the result.
    ``control`` (the limits' calibration only, never the benchmark's
    runs): also check the reference held in bfloat16 against the
    reference, under the result's key "control"."""
    # the parts of the set-up, printed: from the process's start to here
    # (the imports), the frames (with the card's context), the app, the
    # warm-up
    marks = [("to the harness", time.perf_counter())]
    t_start = marks[0][1] if t_start is None else t_start
    device = torch.device(device)
    bench = spec.load_benchmark(root)
    entry, config_entry = spec.cell(bench, workload)
    config = spec.load_config(config_entry, root)
    if config_override:
        config = config_override(config)
    driver = spec.app_driver(config)
    mix = load_mix(entry["traffic"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    loop = make_loop(config, mix, seed, device)
    marks.append(("frames rendered", time.perf_counter()))
    system = driver.System(config, loop, seed, device)
    marks.append(("app built", time.perf_counter()))
    rec = Recorder(device, trace)
    system.instrument(rec)
    try:
        result = _run(bench, entry, config, loop, system, rec, seed,
                      seconds, trace, device, t_start, marks, control, err)
    finally:
        rec.restore()
    print(json.dumps(result), file=out, flush=True)
    return result


def _step(system, rec, loop, k, capture):
    """One frame: (ms to the pose on the host, device flag 'finite',
    raised)."""
    frame = loop.frame(k)
    t0 = time.perf_counter()
    try:
        with rec.frame_scope(k, capture):
            if capture:
                rec.captures.setdefault(k, {})["prev"] = copy_of(
                    system.snapshot())
            state = system.estimate(frame)
        pose = system.read_pose(state)
    except Exception as e:      # a failed frame is counted, not fatal
        return (time.perf_counter() - t0) * 1e3, None, repr(e)
    ms = (time.perf_counter() - t0) * 1e3
    if capture:
        rec.captures[k]["out"] = copy_of(state)
    finite = system.finite(state) & bool(np.isfinite(pose).all())
    return ms, finite, None


def _run(bench, entry, config, loop, system, rec, seed, seconds,
         trace, device, t_start, marks, control, err):
    chips = int(entry["chips"])
    period = len(loop.frames)
    n_warm = system.warm_frames
    for k in range(n_warm):
        _, finite, raised = _step(system, rec, loop, k, k < START_FRAMES)
        if raised is not None:
            raise RuntimeError(f"warm-up frame {k} raised: {raised}")
    rec.sync()

    # ------------------------------------------------ the measured window
    sample = Reservoir(seed, CHECK_FRAMES)
    ms, finites, errors = [], [], []
    prof = None
    # the program's trace: on its own frames (kept), and under the
    # profiler (its spans become the profiler's annotations)
    program, annotated = ExitStack(), ExitStack()
    program_block, program_frames = None, 0
    t_open = time.perf_counter()
    setup_s = t_open - t_start
    marks.append(("warm-up", t_open))
    k = n_warm
    try:
        while time.perf_counter() - t_open < seconds:
            w = k - n_warm
            if trace and device.type == "cuda" and w == PROFILED[0]:
                prof = _start_profiler()
                rec.keep_calls = True
                annotated.enter_context(program_trace())
            in_program = trace and within(PROGRAM_TRACED, w)
            if in_program and program_block is None:
                program_block = program.enter_context(program_trace())
            rec.spans_on = not in_program
            rec.count_syncs = trace and within(SYNC_COUNTED, w)
            capture, displaced = sample.offer(k)
            if displaced is not None:
                rec.drop(displaced)
            if prof is not None and rec.keep_calls:
                with torch.profiler.record_function("frame"):
                    took, finite, raised = _step(system, rec, loop, k,
                                                 capture)
                    rec.sync()
            else:
                took, finite, raised = _step(system, rec, loop, k, capture)
            if prof is not None and rec.keep_calls and \
                    w == PROFILED[0] + PROFILED[1] - 1:
                rec.sync()
                annotated.close()
                prof.stop()
                rec.keep_calls = False
            if in_program:
                program_frames += 1
                if w == PROGRAM_TRACED[0] + PROGRAM_TRACED[1] - 1:
                    program.close()
            ms.append(took)
            if raised is not None:
                errors.append((k, raised))
                if capture:
                    rec.drop(k)
            else:
                finites.append(finite)
            k += 1
        rec.count_syncs = False
        if device.type == "cuda":
            torch.cuda.synchronize()
        t_close = time.perf_counter()
    finally:
        # where the window ended inside a stretch
        program.close()
        annotated.close()
        rec.spans_on = True
    if prof is not None and rec.keep_calls:
        prof.stop()
        rec.keep_calls = False

    attempted = len(ms)
    nonfinite = (int(torch.stack([torch.as_tensor(f) for f in finites])
                     .logical_not().sum()) if finites else 0)
    failed = len(errors) + nonfinite
    window_s = t_close - t_open
    metrics = {}
    device_info = device_summary(device, chips)
    log(err, f"{entry['name']}: seed {seed}, {attempted} frames in "
        f"{window_s:.3f} s, {failed} failed ({len(errors)} raised, "
        f"{nonfinite} non-finite); period {period} frames, start "
        f"{loop.start}; set-up {setup_s:.3f} s (" + ", ".join(
            f"{name} {t - t_prev:.3f}" for (name, t), t_prev in zip(
                marks, [t_start] + [t for _, t in marks[:-1]])) + ")")
    for k_err, message in errors[:3]:
        log(err, f"frame {k_err} raised {message}")
    log(err, f"card: {power_limit()}; peak device memory "
        f"{device_info['memory_peak_bytes']} B")
    log(err, "plan mix of the window: " + system.plan_mix(
        range(n_warm, n_warm + attempted)))

    if not trace:
        values = {
            "fps": attempted / window_s,
            "pose_ms_p95": float(np.percentile(ms, 95)) if ms else None,
            "setup_s": setup_s,
        }
        if ms:
            log(err, f"pose ms: median {np.median(ms):.3f}, p95 "
                f"{values['pose_ms_p95']:.3f}, max {max(ms):.3f} over "
                f"{len(ms)} frames")
        for m in spec.metrics_of(bench, entry["name"], "end_to_end"):
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
        breakdown = None
    else:
        from bench_port.harness import trace as trace_mod
        events = None if prof is None else trace_mod.trace_events(prof)
        record = trace_mod.TraceRecord(rec, events, n_warm, attempted,
                                       PROFILED, program_block,
                                       program_frames)
        del events
        for line in record.lines():
            log(err, line)
        for m in spec.metrics_of(bench, entry["name"], "per_layer"):
            value = spec.metric_reader(m["name"]).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info["busy_s"] = record.busy_s
        device_info["window_s"] = record.window_s
        breakdown = record.breakdown()

    # ------------------------------------------------------- the check
    system.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = system.check(rec.captures, loop, config, seed, device, err)
    limits = config.get("limits", {})
    checks = {name: {"value": value, "limit": limits.get(name)}
              for name, value in numbers.items()}
    correct = (failed == 0 and bool(checks) and all(
        c["limit"] is not None and c["value"] <= c["limit"]
        for c in checks.values()))
    log(err, f"check of {len(rec.captures)} frames in "
        f"{time.perf_counter() - t_check:.2f} s")
    forbidden = loaded_forbidden()
    if forbidden:
        raise SystemExit(f"bench_port: loaded {forbidden}: the benchmark "
                         "must not load JAX or the JAX package")
    for name, c in checks.items():
        log(err, f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if control:
        result["control"] = system.check(rec.captures, loop, config, seed,
                                         device, err, control=True)
    result["checks"] = checks
    return result


def _start_profiler():
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof
