#!/usr/bin/env python3
"""Smoke test of the tadataka_torch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernel from this checkout, checks it against its
plain PyTorch version on the card, runs a short sequence through the
port on the CPU and on the card and compares them, then drives the
semi-dense VO slice (``SemiDenseVO.estimate``) at 480x640 over 12
synthetic frames and checks its output against ground truth.  Every
phase prints a line; any failure ends the script with a traceback and a
non-zero exit.  The last lines are the card's name and power limit, a
JSON line of per-kernel results, and a JSON line
``{"ok": true, "device": {...}}``.

Without a CUDA device, or outside a checkout of the repository, the
script exits non-zero and prints no result.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SSD_SOURCE = "tadataka_torch/vo/semi_dense/csrc/ssd_search.cu"
SSD_REPLACES = "tadataka_tpu/vo/semi_dense/sweep.py:184"

# the slice at full size
VGA = (480, 640)
VGA_FOCAL = 480.0
N_FRAMES = 12
SLICE_ARGS = dict(default_depth=8.0, default_variance=1.0,
                  uncertainty_bias=0.01, depth_range=(2.0, 50.0),
                  history_size=8, n_coarse_to_fine=5)


def log(phase, message):
    print(f"[{phase}] {message}", flush=True)


def trajectory(n, step=(0.02, 0.002, 0.01), yaw=0.002, device="cpu"):
    """Camera->world poses: rotvec (0, yaw i, 0), t = step * i."""
    from tadataka_torch.core.pose import Pose
    return [Pose.from_rotvec(
        torch.tensor([0.0, yaw * i, 0.0], device=device),
        torch.tensor([s * i for s in step], device=device))
        for i in range(n)]


def make_vo(shape, focal, device, metrics=None, **overrides):
    from tadataka_torch.apps import SemiDenseVO
    from tadataka_torch.camera import CameraParameters
    from tadataka_torch.vo.semi_dense import SemiDenseParams
    H, W = shape
    args = dict(SLICE_ARGS, **overrides)
    return SemiDenseVO(
        CameraParameters.create((focal, focal), (W / 2.0, H / 2.0),
                                device=device),
        params=SemiDenseParams.create(2.0, 50.0, ref_step_size=0.002,
                                      min_gradient=0.01, device=device),
        metrics=metrics, device=device, **args)


class PlanLog:
    """Collects the planner's decision of every frame."""

    def __init__(self):
        self.frames = []

    def log_frame(self, frame_index, **values):
        self.frames.append((frame_index, values))


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_sequence(frames, vo, device, before=None):
    """Drive ``vo.estimate`` over the frames, bootstrapping frame 1 with
    the true pose; ``before(k)`` runs ahead of frame k, off the clock.
    Returns (states, per-frame ms)."""
    vo.initial_pose_fn = lambda image0, image1: (
        frames[1].pose.inv() * frames[0].pose)
    states, ms = [], []
    for k, frame in enumerate(frames):
        if before is not None:
            before(k)
        sync(device)
        t0 = time.perf_counter()
        states.append(vo.estimate(frame))
        sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
    return states, ms


# ---------------------------------------------------------------- phases

def phase_environment():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log("env", f"python {sys.version.split()[0]}, torch {torch.__version__}"
        f", cuda {torch.version.cuda}, card {torch.cuda.get_device_name(0)}"
        f", devices {torch.cuda.device_count()}")
    log("env", f"nvidia-smi: {smi}")
    log("env", "allow_tf32: matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}, cudnn "
        f"{torch.backends.cudnn.allow_tf32} (the port runs no convolution)")
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmuls are on: the port's 6x6 solves and "
                           "resizes need full float32")
    return smi


def phase_build():
    from tadataka_torch.vo.semi_dense.sweep import ssd_library
    built = ssd_library()
    log("build", f"{SSD_SOURCE} -> {built.path.name} in "
        f"{built.seconds:.2f} s")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            log("build", "ptxas: " + line.strip())


def ssd_inputs(S, H, W, seed):
    """Random plane volume with ~20% invalid lanes, all-invalid rows,
    narrow window ranges on half the pixels, a planted key patch and
    exact planted ties, on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    M = S - 4
    V = torch.rand((S, H, W), generator=gen, device=dev)
    V[torch.rand((S, H, W), generator=gen, device=dev) < 0.2] = -1.0
    K = torch.rand((5, H, W), generator=gen, device=dev)
    V[6:11, :, : W // 4] = K[:, :, : W // 4]           # planted at m = 6
    V[S - 5:, :, : W // 8] = K[:, :, : W // 8]         # ... and tied at M-1
    V[:, :3] = -1.0                                    # all-invalid pixels
    mlo = torch.zeros((H, W), device=dev)
    mhi = torch.full((H, W), float(M - 1), device=dev)
    narrow = torch.rand((H, W), generator=gen, device=dev) < 0.5
    lo = torch.randint(0, M, (H, W), generator=gen, device=dev).float()
    width = torch.randint(0, 5, (H, W), generator=gen, device=dev).float()
    mlo = torch.where(narrow, lo, mlo)
    mhi = torch.where(narrow, lo + width, mhi)
    return V, K, mlo, mhi


def cuda_ms(fn, repeats=20, flush_bytes=256 << 20):
    """Median device ms of ``fn`` over ``repeats`` runs, each timed with
    CUDA events after the L2 cache is flushed by writing a larger
    buffer (the SSD volume is read cold on the main path)."""
    flush = torch.empty(flush_bytes // 4, dtype=torch.float32, device="cuda")
    fn()
    times = []
    for _ in range(repeats):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_kernel_vs_plain():
    """The SSD kernel against its plain version on the same tensors."""
    from tadataka_torch.vo.semi_dense.sweep import (
        ssd_search, ssd_search_reference)
    results = {}
    max_abs_err = 0.0
    for S, H, W in ((32, 480, 640), (48, 480, 640), (128, 480, 640),
                    (48, 479, 640)):
        args = ssd_inputs(S, H, W, seed=S * 1000 + H)
        out = ssd_search(*args)
        ref = ssd_search_reference(*args)
        torch.cuda.synchronize()
        best_eq = (out[0] == ref[0])
        share = best_eq.float().mean().item()
        bit_equal = all(torch.equal(a, b) for a, b in zip(out, ref))
        diffs = [torch.where(best_eq, (a - b).abs(), 0.0).max().item()
                 for a, b in zip(out[1:], ref[1:])]
        err = max(diffs)
        max_abs_err = max(max_abs_err, err)
        matches = (ref[0] >= 0).float().mean().item()
        if not bit_equal and not (share >= 0.9999 and err <= 1e-6):
            raise AssertionError(
                f"SSD kernel disagrees with its plain version at "
                f"S={S} {H}x{W}: best equal on {share:.6f}, max |d| {err}")
        ms = cuda_ms(lambda: ssd_search(*args))
        plain_ms = cuda_ms(lambda: ssd_search_reference(*args))
        v_bytes = S * H * W * 4
        log("kernel", f"ssd_search S={S} {H}x{W}: "
            f"{'bit-equal' if bit_equal else 'within tolerance'} to plain "
            f"(best equal on {share:.6f} of pixels, max |d| {err}); "
            f"{matches:.3f} of pixels match; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, V read {v_bytes / 1e6:.1f} MB -> "
            f"{v_bytes / ms / 1e6:.1f} GB/s")
        results[(S, H, W)] = (ms, plain_ms)
    return results, max_abs_err


def rel_quantiles(a, b, mask):
    rel = np.abs(a - b)[mask] / np.abs(a)[mask]
    return float(np.median(rel)), float(np.quantile(rel, 0.9))


def difference(a, b):
    """'bit-equal' or the largest |a - b| of two numpy arrays."""
    if np.array_equal(a, b):
        return "bit-equal"
    return f"max |d| {np.abs(a.astype(np.float64) - b).max():.3g}"


def compare_stages(devices):
    """Each stage of one steady-state frame on the same inputs (a 120x160
    scene, the app's uint8 images, a prior near the true depth) on both
    devices.  The port rounds the same on both (core/rounding.py), so the
    image, the age map, a plane stack and the propagated maps are
    bit-equal; the sweep and DVO, which are too (their lines say so), are
    held to the ceilings: flags agreeing on >= 99% of pixels, median
    relative depth d <= 1e-3 on pixels SUCCESS on both, pose d <= 1e-3."""
    from tadataka_torch.apps.semi_dense_vo import prepare_image, to_gray_f32
    from tadataka_torch.camera import CameraModel
    from tadataka_torch.dataset import multi_plane_scene
    from tadataka_torch.vo.dvo import estimate_pose_pyramid
    from tadataka_torch.vo.semi_dense import (
        SemiDenseParams, increment_age, make_frame, propagate, stack_frames)
    from tadataka_torch.vo.semi_dense.fast import plan_update
    from tadataka_torch.vo.semi_dense.sweep import (
        update_depth_sweep, warp_plane_stack)
    shape, focal = (120, 160), 120.0
    ds = multi_plane_scene(4, shape, (focal, focal),
                           trajectory(4, step=(0.12, 0.01, 0.1)))
    frames = [ds[i] for i in range(4)]
    gen = np.random.default_rng(0)
    gt = frames[3].depth_map.numpy()
    prior_depth = (gt * gen.uniform(0.9, 1.1, shape)).astype(np.float32)
    prior_var = gen.uniform(0.002, 0.02, shape).astype(np.float32)
    age = gen.integers(1, 4, shape).astype(np.int32)
    weights = (1.0 / gen.uniform(0.01, 1.0, shape)).astype(np.float32)
    dvo_depth = (frames[2].depth_map.numpy()
                 * gen.uniform(0.97, 1.03, shape)).astype(np.float32)
    out = []
    for device in devices:
        def t(a, dtype=torch.float32):
            return torch.as_tensor(a, dtype=dtype, device=device)
        cam = type(ds.camera_model.camera_parameters)(
            *(x.to(device) for x in ds.camera_model.camera_parameters))
        params = SemiDenseParams.create(2.0, 50.0, ref_step_size=0.002,
                                        min_gradient=0.01, device=device)
        images = [to_gray_f32(prepare_image(f, device)) for f in frames]
        key = make_frame(cam, images[3], frames[3].pose.T.to(device))
        refs = stack_frames([make_frame(cam, images[k],
                                        frames[k].pose.T.to(device))
                             for k in range(3)])
        plan = plan_update(key, refs, params)
        assert plan.path == "tent", plan
        depth, var, flags = update_depth_sweep(
            key, refs, t(age, torch.int32), t(prior_depth), t(prior_var),
            params, n_planes=plan.n_planes, redirect=plan.redirect,
            fuse_prior=True)
        T_rk = (frames[2].pose.inv() * frames[3].pose).T.to(device)
        qs = torch.linspace(0.02, 0.5, plan.n_planes[2], device=device)
        V = warp_plane_stack(images[2], T_rk, qs, cam.focal_length,
                             cam.offset, cam.focal_length, cam.offset)
        T10 = (frames[3].pose.inv() * frames[2].pose).T.to(device)
        cm = CameraModel.create(cam)
        R, tr = estimate_pose_pyramid(
            cm, cm, images[2], t(dvo_depth), images[3], t(weights),
            torch.eye(3, device=device), torch.zeros(3, device=device),
            4, 20, 1.5, "map", "ic")
        age1 = increment_age(t(age, torch.int32), cam, cam, T10,
                             t(prior_depth))
        d1, v1 = propagate(T10, cam, cam, t(prior_depth), t(prior_var),
                           8.0, 1.0, 0.01)
        out.append([x.cpu().numpy() for x in
                    (images[3], age1, V, d1, v1, depth, var, flags, R, tr)])
    (image_c, age_c, V_c, d1_c, v1_c, depth_c, var_c, flags_c, R_c, t_c), \
        (image_g, age_g, V_g, d1_g, v1_g, depth_g, var_g, flags_g, R_g,
         t_g) = out
    flags_agree = float(np.mean(flags_c == flags_g))
    both = (flags_c == 0) & (flags_g == 0)
    med, p90 = rel_quantiles(depth_c, depth_g, both)
    pose_d = max(float(np.abs(R_c - R_g).max()),
                 float(np.abs(t_c - t_g).max()))
    log("cpu-gpu", "stages on the same inputs: image "
        f"{difference(image_c, image_g)}; age {difference(age_c, age_g)}; "
        f"plane stack ({V_c.shape[0]} planes) {difference(V_c, V_g)}; "
        "propagated depth "
        f"{difference(d1_c, d1_g)}, variance {difference(v1_c, v1_g)}; "
        f"sweep flags agree {flags_agree:.5f}, SUCCESS both "
        f"{both.mean():.3f}, depth rel d median {med:.3g} p90 {p90:.3g}, "
        f"{difference(depth_c, depth_g)}; DVO pose d {pose_d:.3g}")
    assert np.array_equal(image_c, image_g)
    assert np.array_equal(age_c, age_g)
    assert np.array_equal(V_c, V_g)
    assert np.array_equal(d1_c, d1_g) and np.array_equal(v1_c, v1_g)
    assert flags_agree >= 0.99 and med <= 1e-3, (flags_agree, med)
    assert both.mean() > 0.1
    assert pose_d <= 1e-3, pose_d


def compare_sequences(devices):
    """The same 6-frame 120x160 sequence (rendered once, on the CPU)
    through SemiDenseVO on the CPU and twice on the card.  Every frame:
    pose d <= 1e-3, flags agreeing on >= 99% of pixels and median
    relative depth d <= 1e-3 on pixels SUCCESS on both (the port gives
    the same bits on both devices, and the lines say whether it did).
    The second card run shows whether the card repeats itself."""
    from tadataka_torch.dataset import multi_plane_scene
    ds = multi_plane_scene(6, (120, 160), (120.0, 120.0),
                           trajectory(6, step=(0.12, 0.01, 0.1)))
    frames = [ds[i] for i in range(6)]
    runs = []
    for device in devices:
        plans = PlanLog()
        vo = make_vo((120, 160), 120.0, device, metrics=plans)
        states, _ = run_sequence(frames, vo, device)
        runs.append([
            tuple(x.cpu().numpy() if x is not None else None
                  for x in (s.pose_wc.T, s.depth_map, s.flag_map))
            for s in states])
        assert all(p["plan_path"] == "tent" for _, p in plans.frames), \
            plans.frames
    failed = []
    for k, (c, g, g2) in enumerate(zip(*runs)):
        repeat = all(np.array_equal(a, b) for a, b in zip(g, g2)
                     if a is not None)
        pose_d = float(np.abs(c[0] - g[0]).max())
        if c[2] is None:
            if not (pose_d == 0.0 and np.array_equal(c[1], g[1])):
                failed.append(k)
            continue
        flags_agree = float(np.mean(c[2] == g[2]))
        med, p90 = rel_quantiles(c[1], g[1], (c[2] == 0) & (g[2] == 0))
        same = all(np.array_equal(a, b) for a, b in zip(c, g))
        log("cpu-gpu", f"sequence frame {k}: pose d {pose_d:.3g}, flags "
            f"agree {flags_agree:.5f}, depth rel d median {med:.3g} p90 "
            f"{p90:.3g}{', bit-equal' if same else ''}; second card run "
            f"{'identical' if repeat else 'differs'}")
        if not (np.all(np.isfinite(g[1])) and pose_d <= 1e-3
                and flags_agree >= 0.99 and med <= 1e-3):
            failed.append(k)
    assert not failed, f"CPU and card differ beyond the bounds on {failed}"


def phase_cpu_vs_gpu(devices=("cpu", "cuda")):
    """The port on the CPU (plain SSD) against the port on the card (the
    kernel): stage by stage, then a whole sequence."""
    compare_stages(devices)
    compare_sequences(devices + devices[1:])


# The JAX package on phase 5's trajectory and parameters at 1/4 and 1/2
# of its size (tools/slice_vs_jax.py, random and true initial maps), last
# frame: SUCCESS share 0.099-0.126, median |depth - GT| 1.22-1.84 on
# SUCCESS pixels, cos(t_est, t_gt) 0.598-0.700.  The test_apps gates
# (> 0.2, < 1.0, > 0.9) are out of the reference's reach on this
# trajectory (see PERF.md), so phase 5 holds the port to the reference's
# range with stated margins, and phase_app_gate runs the test_apps gates
# on their own sequence.
SLICE_GATES = dict(success=0.5 * 0.099, err=1.25 * 1.84, cos=0.598 - 0.1)


def phase_slice(device="cuda", shape=VGA, focal=VGA_FOCAL):
    """The slice at full size, timed, with the quality gates.  Frames are
    rendered on the CPU, as a camera delivers them to the host."""
    from tadataka_torch.dataset import multi_plane_scene
    from tadataka_torch.flags import Flag
    from tadataka_torch.vo.semi_dense.sweep import ssd_search
    ds = multi_plane_scene(N_FRAMES, shape, (focal, focal),
                           trajectory(N_FRAMES))
    frames = [ds[i] for i in range(N_FRAMES)]
    plans = PlanLog()
    vo = make_vo(shape, focal, device, metrics=plans)

    last_inputs = {}

    def keep_last_inputs(k):
        if k == N_FRAMES - 1:
            last_inputs.update(prev=vo.state, prev_image=vo._prev_image,
                               refs=tuple(vo.refframes[-vo.history_size:]))

    ssd_search.launches = 0
    states, ms = run_sequence(frames, vo, device, before=keep_last_inputs)
    launches = ssd_search.launches

    n_updates = N_FRAMES - 1
    paths = [p["plan_path"] for _, p in plans.frames]
    log("slice", "plans: " + ", ".join(
        f"{p['plan_path']}/{p['plan_n_planes']}" for _, p in plans.frames))
    assert paths == ["tent"] * n_updates, paths
    assert launches == n_updates, (launches, n_updates)
    for s in states:
        for x in (s.depth_map, s.variance_map, s.pose_wc.R, s.pose_wc.t):
            assert bool(torch.isfinite(x).all())

    init_err = np.median(np.abs(states[0].depth_map.cpu().numpy()
                                - frames[0].depth_map.numpy()))
    boot_success, boot_err, _ = depth_and_pose_quality(states[1], frames[1])
    success, err, cos = depth_and_pose_quality(states[-1], frames[-1])
    flags = states[-1].flag_map.cpu().numpy()
    shares = ", ".join(f"{f.name} {np.mean(flags == int(f)):.3f}"
                       for f in Flag if np.any(flags == int(f)))
    steady = ms[3:]
    fps = 1e3 * len(steady) / sum(steady)
    log("slice", "per-frame ms: " + ", ".join(f"{m:.1f}" for m in ms))
    log("slice", f"steady state (frames 3-{N_FRAMES - 1}): "
        f"{sum(steady) / len(steady):.2f} ms/frame, {fps:.2f} fps; "
        f"ssd_search launches {launches} for {n_updates} sweep updates")
    log("slice", f"initial map: median |depth - GT| {init_err:.3f}; "
        f"bootstrap frame: SUCCESS share {boot_success:.3f}, median "
        f"|depth - GT| {boot_err:.4f}; last frame: SUCCESS share "
        f"{success:.3f}, median |depth - GT| {err:.4f}, cos(t_est, t_gt) "
        f"{cos:.4f}")
    log("slice", f"last frame's flags: {shares}")
    assert boot_err < 0.25 * init_err, (boot_err, init_err)
    gates = SLICE_GATES
    assert (success > gates["success"] and err < gates["err"]
            and cos > gates["cos"]), (success, err, cos, gates)

    stage_times(vo, frame=frames[-1], device=device, **last_inputs)
    return launches


def depth_and_pose_quality(state, frame):
    """(SUCCESS share, median |depth - GT| on SUCCESS, cos(t_est, t_gt))."""
    success = (state.flag_map == 0).cpu().numpy()
    err = np.abs(state.depth_map.cpu().numpy()
                 - frame.depth_map.cpu().numpy())[success]
    t_est = state.pose_wc.t.cpu().numpy()
    t_gt = frame.pose.t.cpu().numpy()
    cos = float(t_est @ t_gt / (np.linalg.norm(t_est)
                                * np.linalg.norm(t_gt) + 1e-12))
    return float(success.mean()), float(np.median(err)), cos


def phase_app_gate(device="cuda"):
    """The repository's own end-to-end gate of SemiDenseVO (the JAX
    package's tests/vo/test_apps.py): 80x100, five frames at 0.18 m a
    frame, history 4, 4 levels; SUCCESS share > 0.2, median |depth - GT|
    < 1.0 on SUCCESS pixels and cos(t_est, t_gt) > 0.9 on the last
    frame, run on the card."""
    from tadataka_torch.dataset import multi_plane_scene
    from tadataka_torch.vo.semi_dense.sweep import ssd_search
    ds = multi_plane_scene(5, (80, 100), (80.0, 80.0),
                           trajectory(5, step=(0.18, 0.01, 0.01),
                                      device=device), device=device)
    frames = [ds[i] for i in range(5)]
    plans = PlanLog()
    vo = make_vo((80, 100), 80.0, device, metrics=plans, history_size=4,
                 n_coarse_to_fine=4)
    before = ssd_search.launches
    states, _ = run_sequence(frames, vo, device)
    success, err, cos = depth_and_pose_quality(states[-1], frames[-1])
    log("app-gate", f"80x100, 5 frames: plans "
        f"{[p['plan_path'] for _, p in plans.frames]}, SUCCESS share "
        f"{success:.3f}, median |depth - GT| {err:.4f}, cos(t_est, t_gt) "
        f"{cos:.4f}")
    if torch.device(device).type == "cuda":
        assert ssd_search.launches - before == 4
    assert success > 0.2 and err < 1.0 and cos > 0.9, (success, err, cos)


def stage_times(vo, prev, prev_image, refs, frame, device):
    """Median ms of each stage of one steady-state frame, calling the
    port's stage functions on that frame's inputs."""
    from tadataka_torch.apps.semi_dense_vo import (
        prepare_image, track, propagate_step, update, to_gray_f32)
    from tadataka_torch.core.rounding import matmul_small
    from tadataka_torch.core.transforms import inv_motion_matrix
    from tadataka_torch.vo.semi_dense import make_frame, stack_frames
    from tadataka_torch.vo.semi_dense import regularize
    from tadataka_torch.vo.semi_dense.fast import plan_update
    image = to_gray_f32(prepare_image(frame, device))
    cam = vo.camera_params

    def timed(fn, repeats=5):
        fn()
        times = []
        for _ in range(repeats):
            sync(device)
            t0 = time.perf_counter()
            out = fn()
            sync(device)
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times), out

    ms_track, T10 = timed(lambda: track(
        vo._camera_model, prev_image, prev.depth_map, prev.variance_map,
        image, vo.n_coarse_to_fine))
    ms_prop, (d1, v1, age1) = timed(lambda: propagate_step(
        cam, T10, prev.depth_map, prev.variance_map, prev.age_map,
        vo.default_depth, vo.default_variance, vo.uncertainty_bias))
    T_wk = matmul_small(prev.pose_wc.T, inv_motion_matrix(T10))
    plan = plan_update(make_frame(cam, image, T_wk), stack_frames(refs),
                       vo.params)
    assert plan.path == "tent", plan
    ms_update, (d2, v2, flags) = timed(lambda: update(
        cam, vo.params, image, T_wk, refs, age1, d1, v1, plan, False,
        vo.fuse_prior))
    ms_reg, _ = timed(lambda: regularize(d2, v2, flags))
    log("stages", f"one {tuple(image.shape)} frame, median of 5: track "
        f"{ms_track:.2f} "
        f"ms, propagate {ms_prop:.2f} ms, update {ms_update:.2f} ms "
        f"(plan {plan.n_planes}), regularize {ms_reg:.2f} ms")


def main():
    smi = phase_environment()
    sys.path.insert(0, str(ROOT))
    t0 = time.perf_counter()
    phase_build()
    timings, max_abs_err = phase_kernel_vs_plain()
    phase_cpu_vs_gpu()
    launches = phase_slice()
    phase_app_gate()
    ms, plain_ms = timings[(48, 480, 640)]
    log("done", f"all phases passed in {time.perf_counter() - t0:.1f} s; "
        "kernel ms/plain_ms below are at S=48, 480x640")
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "ssd_search", "route": "cuda", "source": SSD_SOURCE,
        "replaces": SSD_REPLACES, "launches": launches,
        "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
