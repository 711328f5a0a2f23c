#!/usr/bin/env python3
"""Smoke test of the tadataka_torch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout (one nvcc per source,
all at once), checks each against its plain PyTorch version on the
card (the SSD search bit for bit, on inputs of both of the kernels its
launcher picks from, timed beside the bound at its inputs, and the PnP
normal-equation kernel), drives the SSD probes'
entry point (``tadataka_torch.probes.exp_ssd``) and the gather probes'
(``tadataka_torch.probes.dynamic_gather`` and ``flat_gather``),
compares the port on the CPU and on the card stage by stage and over a
short sequence, then drives ``SemiDenseVO.estimate`` at 480x640 on
three paths: the homography sweep over 12 synthetic frames, the
rectified sweep over 10 frames of a lateral trajectory, and the
scattered estimator (``depth_update="scatter"``) over 5 frames, each
checked against ground truth.  The SSD searches of one steady frame of
the first two are recorded as the main path made them, and the search
is checked and timed on them.  Last it runs DVO on the CPU and
on the card on the same inputs and drives ``DvoTrajectory`` over 8
frames of a TUM RGB-D freiburg1 scene at 480x640, exported and read
back through the TUM loader, gated on its trajectory error.  Then
stereo depth at 480x640 and 128 disparities (``stereo``), the EuRoC
export at 480x752 read back with its stereo depth, and a NewTsukuba tree
read back (``euroc``), and ``PipelinedSemiDenseVO`` (tracker and mapper
on two streams) at 480x640 beside ``SemiDenseVO`` (``pipelined``), each
held bit for bit to the CPU and gated against the JAX package's
readings.  Then ``FeatureBasedVO`` (``feature``) on the EuRoC export at
480x752 and on the multi-plane scene at 480x640, gated on its trajectory
against the JAX package's readings, and on the EuRoC frames and the
reference's 120x160 test sequence on the CPU and the card with the same
draws: poses, map and every value the VO probes stage by stage bit for
bit (the first that parts is named).  Last, ``VitaminEVO``
(``vitamin_e``) at 480x640: its curvature, extrema, ORB descriptors,
tracks, poses and map bit for bit on the CPU and the card, its
trajectory and map gated on the JAX package's readings, its host
syncs a frame printed.  Then ``parallel``: the
last `tent` update of phase 5 column-sharded over 4 shards of the card
(``make_sharded_update_sweep``: an ssd_search launch a shard, the maps
bit for bit the one-device update's and the CPU's) and row-sharded
(``sharded_update_depth``), the landmark-sharded BA at 10,240 landmarks
(CPU and card bit for bit), and the BA in two processes that share the
card through a gloo group (the script runs itself with ``--ba-worker``
for each).  Last, ``long``: tests/vo/test_long_trajectory.py's 30-frame
sequence at 80x100 on the CPU and the card (DVO's poses, the map after
every update, the feature VO's poses and map, bit for bit), then 30
frames at 480x640 through SemiDenseVO, PipelinedSemiDenseVO,
DvoTrajectory and FeatureBasedVO, gated on the JAX package's readings
(tools/long_vs_jax.py), with device memory after frames 10 and 29
(held for the semi-dense apps).  Frame and stage times are the
benchmark's (``bench_port/``); this script times kernels alone.  Every
phase prints lines; any failure ends the script with a traceback and a
non-zero exit.  The last lines are the card's name and power limit, a
JSON line of per-kernel results, and a JSON line ``{"ok": true,
"device": {...}}``.

Without a CUDA device, or outside a checkout of the repository, the
script exits non-zero and prints no result.
"""

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from bench_port.harness.roofline import (
    PEAK_BYTES_PER_S, PEAK_F32_PER_S, bound_s, ssd_search_work)

ROOT = Path(__file__).resolve().parent
SSD_SOURCE = "tadataka_torch/vo/semi_dense/csrc/ssd_search.cu"
SSD_REPLACES = "tadataka_tpu/vo/semi_dense/sweep.py:184"
PROBE_SOURCE = "tadataka_torch/probes/csrc/ssd_probes.cu"
PROBE_REPLACES = {"ssd_copy_floor": "benchmarks/exp_ssd.py:39",
                  "ssd_serial": "benchmarks/exp_ssd.py:61",
                  "ssd_par": "benchmarks/exp_ssd.py:99"}
GATHER_SOURCE = "tadataka_torch/probes/csrc/gather_probes.cu"
GATHER_REPLACES = {
    "take_along_axis0": "benchmarks/test_dynamic_gather.py:36",
    "take_along_axis1": "benchmarks/test_dynamic_gather.py:40",
    "multi_warp": "benchmarks/test_dynamic_gather.py:80",
    "flat_take": "benchmarks/test_pallas_gather.py:51",
    "flat_take_rows": "benchmarks/test_pallas_gather.py:82"}
PNP_SOURCE = "tadataka_torch/pose_estimation/csrc/pnp_normal.cu"
PNP_REPLACES = "none (the JAX package leaves the PnP Gauss-Newton step to XLA)"
# the slice at full size
VGA = (480, 640)
VGA_FOCAL = 480.0
N_FRAMES = 12
SLICE_ARGS = dict(default_depth=8.0, default_variance=1.0,
                  uncertainty_bias=0.01, depth_range=(2.0, 50.0),
                  history_size=8, n_coarse_to_fine=5)
# the lateral trajectory that plans the rectified sweep
LATERAL = dict(step=(0.1, 0.005, 0.0), yaw=0.002)
N_RECT_FRAMES = 10
N_SCATTER_FRAMES = 5
# the stereo phase: phase 5's scene from a rectified pair 1.4 m apart,
# which puts the planes' disparities at 72-119 px at focal 480, matched
# as bench.py matches its NewTsukuba pairs
STEREO_BASELINE = 1.4
STEREO_MAX_DISPARITY = 128
STEREO_RADIUS = 3
# the euroc phase: EuRoC's own image size, five frames, stereo depth at
# the disparity range of tests/realdata/test_euroc_e2e.py
EUROC_SHAPE = (480, 752)
N_EUROC_FRAMES = 5
EUROC_MAX_DISPARITY = 64
# the pipelined phase's CPU-against-card check
PIPELINED_CHECK = dict(shape=(120, 160), focal=120.0, frames=5)
# the parallel phase: shards on the one card, and the BA at the JAX
# package's realistic scale (tests/parallel/test_parallel.py:185-219)
PARALLEL_SHARDS = 4
PARALLEL_BA = dict(n_viewpoints=8, n_points=10240, obs_per_point=3)


def log(phase, message):
    print(f"[{phase}] {message}", flush=True)


def kernel_entry(name, source, replaces, launches, max_abs_err, ms,
                 plain_ms, n_bytes, flops=0, library_ms=None):
    """One kernel's entry of the kernels JSON line; the bound is
    ``bench_port``'s roofline (the card's data-sheet peaks)."""
    by_bytes = n_bytes / PEAK_BYTES_PER_S >= flops / PEAK_F32_PER_S
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": 1e3 * bound_s(n_bytes, flops),
            "bound_by": "bytes" if by_bytes else "operations",
            "library_ms": library_ms}


def whole_search_work(S, H, W):
    """``ssd_search_work`` of a search with every window in bounds:
    V (S planes), K (5), mlo and mhi read, best and three errors
    written, and every window's float operations."""
    return ssd_search_work(torch.empty(S, 0), torch.zeros(H, W),
                           torch.full((H, W), S - 5.0))


def pnp_normal_bytes_flops(B, n):
    """What one PnP normal-equation step must move and compute: R, t,
    points, keypoints and weights read, the (B, 6, 7) sums written; a
    point's float operations: its transform (15), projection and two
    residuals (8), the 12 Jacobian entries of its two rows (3 each), and
    a row's 6 weightings, 42 products and 42 sums."""
    return 4 * B * (12 + 6 * n + 42), B * n * (15 + 8 + 36 + 2 * 90)


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


def run_sequence(frames, vo, before=None):
    """Drive ``vo.estimate`` over the frames, bootstrapping frame 1 with
    the true pose; ``before(k)`` runs ahead of frame k.  Returns the
    states."""
    vo.initial_pose_fn = lambda image0, image1: (
        frames[1].pose.inv() * frames[0].pose)
    states = []
    for k, frame in enumerate(frames):
        if before is not None:
            before(k)
        states.append(vo.estimate(frame))
    return states


def stereo_pair(shape=VGA, focal=VGA_FOCAL, baseline=STEREO_BASELINE):
    """Phase 5's three planes seen by a rectified pair, the left camera
    at the origin and the right ``baseline`` along its x axis: (camera
    parameters, left image, right image, left depth), rendered on the
    CPU."""
    from tadataka_torch.camera import CameraModel, CameraParameters
    from tadataka_torch.core.pose import Pose
    from tadataka_torch.dataset import render_plane_scene
    from tadataka_torch.dataset.synthetic import MULTI_PLANES
    H, W = shape
    params = CameraParameters.create((focal, focal), (W / 2.0, H / 2.0))
    cm = CameraModel.create(params)
    left, depth = render_plane_scene(cm, Pose.identity(), shape,
                                     planes=MULTI_PLANES)
    right, _ = render_plane_scene(
        cm, Pose(torch.eye(3), torch.tensor([baseline, 0.0, 0.0])), shape,
        planes=MULTI_PLANES)
    return params, left, right, depth


def euroc_stereo(frame0, frame1):
    """(gray cam0, gray cam1, baseline) of one EuRoC stereo frame, as
    tests/realdata/test_euroc_e2e.py takes them: uint8 / 255, and the
    distance between the two camera centres."""
    baseline = float(torch.linalg.norm(frame1.pose.t.double()
                                       - frame0.pose.t.double()))
    gray = [f.image.to(torch.float32) / 255.0 for f in (frame0, frame1)]
    return gray[0], gray[1], baseline


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
    """Build the kernel libraries at once, one nvcc for each source."""
    from concurrent.futures import ThreadPoolExecutor
    from tadataka_torch.probes.exp_ssd import probe_library
    from tadataka_torch.pose_estimation.pnp import pnp_normal_library
    from tadataka_torch.probes.gather import gather_library
    from tadataka_torch.vo.semi_dense.sweep import ssd_library
    t0 = time.perf_counter()
    sources = (SSD_SOURCE, PROBE_SOURCE, GATHER_SOURCE, PNP_SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(lambda build: build(),
                              (ssd_library, probe_library, gather_library,
                               pnp_normal_library)))
    for source, lib in zip(sources, built):
        log("build", f"{source} -> {lib.path.name} in {lib.seconds:.2f} s")
        for line in lib.log.splitlines():
            if "Compiling entry function" in line:
                log("build", "ptxas: " + line.split("'")[1][:110])
            elif "registers" in line or "spill" in line:
                log("build", "ptxas:   " + line.strip())
    log("build", f"all {len(sources)} built in "
        f"{time.perf_counter() - t0:.2f} s")


def log_clocks(phase, when):
    """The card's SM clock, power draw and temperature, beside a timed
    window: kernel times vary from run to run with them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(phase, f"clocks {when}: {smi}")


def warm_up(seconds=2.0):
    """Keep the card busy with matmuls for ``seconds``: it idles at a
    few hundred MHz, and a kernel timed while the clock ramps up reads
    slow."""
    x = torch.rand((4096, 4096), device="cuda")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        x @ x
        torch.cuda.synchronize()


def compare_search(name, out, ref):
    """Hold a search kernel's (best, ec, ep, en) against another's:
    bit-equal, or best equal on >= 0.9999 of pixels with the errors
    within 1e-6 where best is equal.  Returns (bit_equal, share, err)."""
    torch.cuda.synchronize()
    best_eq = out[0] == ref[0]
    share = best_eq.float().mean().item()
    bit_equal = all(torch.equal(a, b) for a, b in zip(out, ref))
    err = max(torch.where(best_eq, (a - b).abs(), 0.0).max().item()
              for a, b in zip(out[1:], ref[1:]))
    if not bit_equal and not (share >= 0.9999 and err <= 1e-6):
        raise AssertionError(f"{name}: best equal on {share:.6f}, max |d| "
                             f"{err}")
    return bit_equal, share, err


def same(a, b):
    """Equal, NaN in the same places (NaN payloads aside)."""
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(
        torch.where(a.isnan(), 0, a), torch.where(b.isnan(), 0, b))


def all_same(out, ref):
    return all(same(a, b) for a, b in zip(out, ref))


def check_search(name, args):
    """ssd_search (the kernel its launcher picks) bit-equal to the plain
    version on ``args``, NaN in the same places; returns the plain
    version's outputs."""
    from tadataka_torch.vo.semi_dense.sweep import (
        ssd_search, ssd_search_reference)
    ref = ssd_search_reference(*args)
    out = ssd_search(*args)
    torch.cuda.synchronize()
    if not all_same(out, ref):
        raise AssertionError(f"ssd_search differs from its plain version on "
                             f"{name}")
    return ref


def time_search(phase, name, args):
    """ssd_search's and the plain version's times on ``args``, in turns
    (medians and quartiles of 20 rounds), beside the bound at these
    inputs; logs one line, returns the numbers."""
    from tadataka_torch.probes.exp_ssd import cuda_times, quartiles
    from tadataka_torch.vo.semi_dense.sweep import (
        ring_config, ssd_search, ssd_search_reference)
    S, H, W = args[0].shape
    plan = ring_config(S, H, W)
    n_bytes, flops = ssd_search_work(args[0], args[2], args[3])
    times = cuda_times({"kernel": lambda: ssd_search(*args),
                        "plain": lambda: ssd_search_reference(*args)})
    ms, q1, q3 = quartiles(times["kernel"])
    plain_ms = statistics.median(times["plain"])
    bound_ms = 1e3 * bound_s(n_bytes, flops)
    log(phase, f"{name} S={S} {H}x{W}: ssd_search {ms:.4f} ms (quartiles "
        f"{q1:.4f}-{q3:.4f}), plain {plain_ms:.4f} ms, timed in turns; "
        f"bound at these inputs {bound_ms:.4f} ms ({bound_ms / ms:.3f} of "
        f"it), reading all of V "
        f"{1e3 * bound_s(*whole_search_work(S, H, W)):.4f} ms; "
        + (f"ring grid {plan['grid']} x {plan['threads']} threads "
           f"({plan['blocks_per_sm']} an SM), {plan['shared_bytes']} B "
           "shared a block" if plan["ring"] else
           "H*W % 4 != 0: the thread kernel runs"))
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                n_bytes=n_bytes, flops=flops)


def pnp_normal_inputs(B, n, seed, nan_point=False):
    """``pnp_normal``'s inputs on the card: B poses near the identity, n
    points 4-6 m ahead, noisy keypoints, every seventh weight 0;
    ``nan_point``: entry 0's point 1 at z + 1e-16 = 0."""
    from tadataka_torch.core.so3 import exp_so3
    gen = torch.Generator(device="cuda").manual_seed(seed)
    R = exp_so3(0.05 * torch.randn((B, 3), generator=gen, device="cuda"))
    t = 0.2 * torch.randn((B, 3), generator=gen, device="cuda")
    X = 2 * torch.rand((B, n, 3), generator=gen, device="cuda") - 1
    X[..., 2] += 5.0
    kp = 0.2 * torch.randn((B, n, 2), generator=gen, device="cuda")
    w = torch.rand((B, n), generator=gen, device="cuda")
    w[:, ::7] = 0.0
    if nan_point:
        R[0], t[0] = torch.eye(3, device="cuda"), 0.0
        X[0, 1] = torch.tensor([0.5, -0.25, -1e-16], device="cuda")
    return R.contiguous(), t, X, kp, w


def check_pnp_normal():
    """The PnP normal-equation kernel bit-equal to its plain version (the
    bit patterns, NaN and signed zeros included) at 1, 3, 2000, 2049
    (just past a power of two of rows) and 5000 points and at P3P's
    batch, NaN sums in two of the cases, then timed in turns with
    the plain version at the VO's shape (B = 1, n = 2000) and P3P's (B =
    512, n = 3) beside the bound.  Returns the VO shape's numbers."""
    from tadataka_torch.probes.exp_ssd import cuda_times
    from tadataka_torch.pose_estimation.pnp import (
        pnp_normal, pnp_normal_reference)
    for B, n, nan_point in ((1, 1, False), (1, 3, False), (1, 2000, False),
                            (1, 2049, True), (1, 5000, False),
                            (512, 3, True)):
        args = pnp_normal_inputs(B, n, seed=B * 7919 + n,
                                 nan_point=nan_point)
        out, ref = pnp_normal(*args), pnp_normal_reference(*args)
        torch.cuda.synchronize()
        if not torch.equal(out.view(torch.int32), ref.view(torch.int32)):
            raise AssertionError(f"pnp_normal differs from its plain "
                                 f"version at B={B}, n={n}")
        log("kernel", f"pnp_normal B={B} n={n}: bit-equal to plain"
            + (f" ({ref.isnan().sum().item()} NaN sums)" if nan_point
               else ""))
    results = {}
    for B, n in ((1, 2000), (512, 3)):
        args = pnp_normal_inputs(B, n, seed=n)
        times = cuda_times({"kernel": lambda: pnp_normal(*args),
                            "plain": lambda: pnp_normal_reference(*args)})
        ms = {k: statistics.median(v) for k, v in times.items()}
        q1, _, q3 = statistics.quantiles(times["kernel"], n=4)
        n_bytes, flops = pnp_normal_bytes_flops(B, n)
        log("kernel", f"pnp_normal B={B} n={n}: kernel {ms['kernel']:.4f} "
            f"ms (quartiles {q1:.4f}-{q3:.4f}), plain {ms['plain']:.4f} ms, "
            f"timed in turns; bound {1e3 * bound_s(n_bytes, flops):.6f} "
            "ms")
        results[(B, n)] = dict(ms=ms["kernel"], plain_ms=ms["plain"],
                               n_bytes=n_bytes, flops=flops)
    return results[(1, 2000)]


def pnp_kernel_launches(tr):
    """The PnP normal-equation kernel's launches in a ``trace()`` block
    of a VO's drive on the card, checked frame by frame: GN_ITERATIONS
    for each "Gauss-Newton" span (one ``solve_pnp_ransac``'s
    refinement), and some such span in the block."""
    from collections import Counter
    from tadataka_torch.pose_estimation.pnp import GN_ITERATIONS
    refinements = Counter(s.frame for s in tr.spans
                          if s.name == "Gauss-Newton")
    launches = tr.counts.get("pnp.normal_kernel", {})
    expected = {f: GN_ITERATIONS * k for f, k in refinements.items()}
    assert refinements and launches == expected, (launches, expected)
    return sum(launches.values())


def phase_kernel_vs_plain():
    """The SSD search bit-equal to the plain version on the same tensors,
    on random stacks up to the rect plan's 256 planes, at odd sizes (H*W
    % 4 of 3 and 1, where the launcher runs the thread kernel) and on
    rect-shaped stacks, each timed beside the bound at its inputs; then
    on stacks whose window errors are NaN (``nan_inputs``, NaN in the
    same places; not timed); the ring kernel's SASS must hold its bulk
    copies (UBLKCP).  Last the PnP normal-equation kernel
    (:func:`check_pnp_normal`), its numbers under "pnp_normal"."""
    from tadataka_torch.probes.ssd_ring import (
        nan_inputs, rect_inputs, ssd_inputs)
    from tadataka_torch.vo.semi_dense.sweep import ring_config, ssd_library
    results = {}
    cases = [("random", S, *VGA) for S in (32, 48, 128, 256)] + [
        ("random", 48, 479, 640), ("random", 48, 479, 641),
        ("random", 16, 37, 41), ("rect", 208, *VGA), ("rect", 256, *VGA)]
    log_clocks("kernel", "idle")
    warm_up()
    log_clocks("kernel", "before")
    for kind, S, H, W in cases:
        make = ssd_inputs if kind == "random" else rect_inputs
        args = make(S, H, W, seed=S * 1000 + H)
        ref = check_search(f"{kind} S={S} {H}x{W}", args)
        log("kernel", f"ssd_search {kind} S={S} {H}x{W}: bit-equal to "
            f"plain; {(ref[0] >= 0).float().mean().item():.3f} of pixels "
            "match")
        results[(kind, S, H, W)] = time_search("kernel", kind, args)
    log_clocks("kernel", "after")
    for S, H, W in ((16, *VGA), (48, *VGA), (256, *VGA), (48, 479, 641)):
        ref = check_search(f"nan S={S} {H}x{W}",
                           nan_inputs(S, H, W, seed=S + H))
        log("kernel", f"ssd_search nan S={S} {H}x{W}: bit-equal to plain, "
            "NaN in the same places (NaN ec on "
            f"{ref[1].isnan().sum().item()}, en on "
            f"{ref[3].isnan().sum().item()} pixels, no best on "
            f"{(ref[0] < 0).sum().item()})")
    lines = kernel_sass(ssd_library(), "ssd_search_ring_kernel")
    counts = {op: sum(op in line for line in lines)
              for op in ("UBLKCP", "UTMALDG", "FFMA", "MUFU")}
    log("kernel", f"SASS of the ring kernel (consumers, planes a stage, "
        f"stages, blocks an SM: {ring_config(48, *VGA)['shape']}): {counts}")
    assert counts["UBLKCP"] > 0 and counts["UTMALDG"] > 0, counts
    results["pnp_normal"] = check_pnp_normal()
    return results


def phase_probes():
    """The probes' entry point (``python -m tadataka_torch.probes.exp_ssd``
    does the same) with every launch count at 0 before it; then each
    probe against its plain version at every S the entry point times
    (32, 48, 128, 256; the two-pass search's slab passes 48 KB from
    S = 100), 480x640, on exp_ssd.py's inputs and on ssd_inputs' harder
    case: the copy floor in every variant (the thread variants and the
    bulk-copy ring), ssd_serial bit-equal to ssd_search and to the plain
    version ("tile" up to S = 128, with its re-score counts, and the
    "thread" kernel in every block shape above), the two-pass search
    bit-equal to its plain version and within compare_search's bounds of
    the serial search (another error form); and the same on
    ``nan_inputs``, NaN in the same places (each form by its own Pallas
    kernel's NaN rule, so the two searches are not compared there).  The
    bulk-copy floor's best time at each S is printed beside the thread
    variants' and torch.sum's, each search beside the bound, the copy
    floor's SASS must hold its bulk copies (UBLKCP; the "tile" kernels
    also UTMALDG), and the instructions a window of each search kernel's
    window loop are printed.  Returns the kernels' JSON entries and the
    measured floor in GB/s."""
    from tadataka_torch.probes import exp_ssd as probes
    from tadataka_torch.probes.ssd_ring import nan_inputs, ssd_inputs
    from tadataka_torch.vo.semi_dense.sweep import ssd_search
    wrappers = (probes.ssd_copy_floor, probes.ssd_serial, probes.ssd_par)
    for fn in wrappers:
        fn.launches = 0
    log_clocks("probes", "before")
    timings = probes.run_probes(log=lambda line: log("probes", line))
    log_clocks("probes", "after")
    launches = {fn.__name__: fn.launches for fn in wrappers}
    assert all(n > 0 for n in launches.values()), launches
    log("probes", f"launches in the probe run: {launches}")

    errs = dict.fromkeys(launches, 0.0)
    for S in probes.PLANES:
        tile = probes.serial_design(S) == "tile"
        for case, args in (("exp_ssd inputs", probes.probe_inputs(S, *VGA)),
                           ("hard case", ssd_inputs(S, *VGA, seed=S)),
                           ("nan case", nan_inputs(S, *VGA, seed=S))):
            V = args[0]
            ref = probes.ssd_copy_floor_reference(V)
            for variant in probes.COPY_VARIANTS:
                out = probes.ssd_copy_floor(V, variant)
                torch.cuda.synchronize()
                if case != "nan case":
                    errs["ssd_copy_floor"] = max(
                        errs["ssd_copy_floor"], (out - ref).abs().max().item())
                assert same(out, ref), (S, case, variant)
            search = ssd_search(*args)
            plain = probes.ssd_serial_reference(*args)
            rescore = (torch.zeros(3, dtype=torch.int64, device="cuda")
                       if tile else None)
            for variant in [()] if tile else probes.SERIAL_VARIANTS:
                out = probes.ssd_serial(*args, *variant, rescore=rescore)
                torch.cuda.synchronize()
                assert all_same(out, search) and all_same(out, plain), \
                    (S, case, variant)
            par = probes.ssd_par(*args)
            par_ref = probes.ssd_par_reference(*args)
            torch.cuda.synchronize()
            if not all_same(par, par_ref):
                raise AssertionError(f"ssd_par differs from its plain "
                                     f"version, {case}, S={S}")
            line = "ssd_par bit-equal to plain"
            if case != "nan case":
                errs["ssd_par"] = max(errs["ssd_par"], max(
                    (a.double() - b.double()).abs().max().item()
                    for a, b in zip(par[1:], par_ref[1:])))
                _, vs_share, vs_err = compare_search(
                    f"ssd_par vs ssd_serial, {case}, S={S}", par, search)
                line += (f", vs ssd_serial: best equal {vs_share:.6f}, "
                         f"max |d| {vs_err}")
            else:
                line += f" (bm = M on {(par[0] == S - 4).sum().item()} pixels)"
            if tile:
                n_exact, n_scan, n_sweep = rescore.tolist()
                serial = (f"tile (re-scored {n_exact / (VGA[0] * VGA[1]):.3f}"
                          f" windows a pixel exactly, {n_scan} pixels scanned"
                          f" every window, {n_sweep} swept again for several"
                          " candidates)")
            else:
                serial = f"thread in {len(probes.SERIAL_VARIANTS)} block shapes"
            log("probes", f"{case}, S={S} 480x640: copy floor bit-equal to "
                f"plain in {len(probes.COPY_VARIANTS)} variants; ssd_serial "
                f"bit-equal to ssd_search and to plain, {serial}; {line}")

    args = probes.probe_inputs(32, *VGA)
    plain_ms = {
        "ssd_copy_floor": probes.cuda_ms(
            lambda: probes.ssd_copy_floor_reference(args[0])),
        "ssd_serial": probes.cuda_ms(
            lambda: probes.ssd_serial_reference(*args)),
        "ssd_par": probes.cuda_ms(lambda: probes.ssd_par_reference(*args))}
    at32 = timings[32]
    best_floor = min(at32["floor"], key=at32["floor"].get)
    ms = {"ssd_copy_floor": at32["floor"][best_floor]}
    for name in ("ssd_serial", "ssd_par"):
        ms[name] = statistics.median(at32["turns"][name])
    log("probes", "the kernels line gives the copy floor's fastest variant "
        f"at S=32 ({probes.copy_variant_name(best_floor)})")
    H, W = VGA
    bulk = [v for v in probes.COPY_VARIANTS if v[0] == "bulk"]
    for S, t in timings.items():
        gb = S * H * W * 4 / 1e6
        floor = min(t["floor"].values())
        old = min(ms for v, ms in t["floor"].items() if v[0] == "threads")
        new = min(t["floor"][v] for v in bulk)
        bound_ms = 1e3 * bound_s(*whole_search_work(S, H, W))
        medians = {name: statistics.median(x)
                   for name, x in t["turns"].items()}
        search = medians["ssd_search"]
        log("probes", f"S={S}: measured V-read floor {floor:.4f} ms "
            f"({gb / floor:.1f} GB/s, {gb / floor / 3350:.3f} of the "
            f"3.35 TB/s data sheet); ssd_search {search:.4f} ms "
            f"({gb / search:.1f} GB/s) = {floor / search:.3f} of "
            "the measured floor; in turns: " + ", ".join(
                f"{name} {m:.4f} ms ({bound_ms / m:.3f} of the "
                f"{bound_ms:.4f} ms bound)" for name, m in medians.items()))
        log("probes", f"S={S}: copy floor, best bulk-copy variant "
            f"{new:.4f} ms ({gb / new:.1f} GB/s), best thread variant "
            f"{old:.4f} ms ({gb / old:.1f} GB/s), torch.sum(V, 0) "
            f"{t['sum']:.4f} ms ({gb / t['sum']:.1f} GB/s): bulk "
            f"{'no slower than' if new <= t['sum'] else 'slower than'} "
            f"torch.sum ({new / t['sum']:.3f}x)")
    built = probes.probe_library()
    sass = kernel_sass(built, "copy_floor_bulk_kernel")
    copies = [line.strip() for line in sass if "UBLKCP" in line]
    log("probes", f"copy_floor_bulk_kernel's SASS: {len(copies)} bulk "
        f"copies (UBLKCP): {copies[:2]}")
    assert copies, "copy_floor_bulk_kernel issues no bulk copy"
    for title, kernel, marker in (
            ("ssd_serial thread", "serial_kernelILi1", "MUFU.RSQ"),
            ("ssd_serial tile", "tile_kernelILb1", "MUFU.RSQ"),
            ("ssd_par slab", "par_kernel", "MUFU.RSQ"),
            ("ssd_par tile", "tile_kernelILb0", "MUFU.RSQ")):
        lines = kernel_sass(built, kernel)
        per_window, unrolled = loop_per_window(lines, marker)
        counts = {op: sum(op in line for line in lines)
                  for op in ("UTMALDG", "UBLKCP")}
        log("probes", f"{title} ({kernel}) SASS: window loop {per_window} "
            f"instructions a window ({unrolled} windows a trip); {counts}")
        if "tile" in title:
            assert counts["UTMALDG"] > 0 and counts["UBLKCP"] > 0, counts
    library_ms = at32["sum"]
    search_work = whole_search_work(32, H, W)
    work = {"ssd_copy_floor": (33 * H * W * 4, 31 * H * W, library_ms),
            "ssd_serial": (*search_work, None),
            "ssd_par": (*search_work, None)}
    floor_gbs = max(S * H * W * 4 / 1e6 / min(t["floor"].values())
                    for S, t in timings.items())
    entries = [kernel_entry(name, PROBE_SOURCE, PROBE_REPLACES[name],
                            launches[name], errs[name], ms[name],
                            plain_ms[name], *work[name])
               for name in PROBE_REPLACES]
    return entries, floor_gbs


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
        states = run_sequence(frames, vo)
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


def compare_updates(devices):
    """The rectified and the scattered update on the same inputs (a
    120x160 lateral scene, a prior near the true depth, ages 1-3) on both
    devices, held to the ceilings of compare_stages: flags agreeing on
    >= 99% of pixels, median relative depth d <= 1e-3 on pixels SUCCESS
    on both (the lines say whether they are bit-equal)."""
    from tadataka_torch.apps.semi_dense_vo import prepare_image, to_gray_f32
    from tadataka_torch.dataset import multi_plane_scene
    from tadataka_torch.vo.semi_dense import (
        SemiDenseParams, make_frame, stack_frames)
    from tadataka_torch.vo.semi_dense.fast import (
        UpdatePlan, update_depth_fast)
    from tadataka_torch.vo.semi_dense.rectify import baseline_flip
    shape, focal = (120, 160), 120.0
    ds = multi_plane_scene(4, shape, (focal, focal),
                           trajectory(4, step=(0.3, 0.01, 0.0)))
    frames = [ds[i] for i in range(4)]
    gen = np.random.default_rng(1)
    gt = frames[3].depth_map.numpy()
    prior_depth = (gt * gen.uniform(0.9, 1.1, shape)).astype(np.float32)
    prior_var = gen.uniform(0.002, 0.02, shape).astype(np.float32)
    age = gen.integers(1, 4, shape).astype(np.int32)
    flips = tuple(baseline_flip(
        (frames[k].pose.inv() * frames[3].pose).T.numpy()) for k in range(3))
    plans = (UpdatePlan("rect", (96,), flips, (), ()),
             UpdatePlan("scatter", (), (), (), ()))
    out = {plan.path: [] for plan in plans}
    for device in devices:
        cam = type(ds.camera_model.camera_parameters)(
            *(x.to(device) for x in ds.camera_model.camera_parameters))
        params = SemiDenseParams.create(2.0, 50.0, ref_step_size=0.002,
                                        min_gradient=0.01, device=device)
        images = [to_gray_f32(prepare_image(f, device)) for f in frames]
        key = make_frame(cam, images[3], frames[3].pose.T.to(device))
        refs = stack_frames([make_frame(cam, images[k],
                                        frames[k].pose.T.to(device))
                             for k in range(3)])
        for plan in plans:
            out[plan.path].append([x.cpu().numpy() for x in update_depth_fast(
                key, refs, torch.as_tensor(age, device=device),
                torch.as_tensor(prior_depth, device=device),
                torch.as_tensor(prior_var, device=device), params,
                plan=plan, fuse_prior=True)])
    for path, ((depth_c, var_c, flags_c), (depth_g, var_g, flags_g)) in \
            out.items():
        flags_agree = float(np.mean(flags_c == flags_g))
        both = (flags_c == 0) & (flags_g == 0)
        med, p90 = rel_quantiles(depth_c, depth_g, both)
        same = all(np.array_equal(a, b) for a, b in zip(
            (depth_c, var_c, flags_c), (depth_g, var_g, flags_g)))
        log("cpu-gpu", f"{path} update (flips {flips}): flags agree "
            f"{flags_agree:.5f}, SUCCESS both {both.mean():.3f}, depth rel "
            f"d median {med:.3g} p90 {p90:.3g}"
            f"{', bit-equal' if same else ''}")
        assert flags_agree >= 0.99 and med <= 1e-3, (path, flags_agree, med)
        assert both.mean() > 0.05, (path, both.mean())


def phase_cpu_vs_gpu(devices=("cpu", "cuda")):
    """The port on the CPU (plain SSD) against the port on the card (the
    kernel): stage by stage, the rect and scatter updates, then a whole
    sequence."""
    compare_stages(devices)
    compare_updates(devices)
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
# The rect phase cannot take its gate from the JAX package: on this
# trajectory (tools/slice_vs_jax.py --trajectory lateral, 1/4 and 1/2
# size, last frame) the reference's tent warps refuse the lanes past
# their 32-px budget, so its SUCCESS share is 0.004-0.089 and its flags
# agree with the port's on only 0.65-0.79 of the pixels (PERF.md).  The
# gate is the port's own range in those runs, with phase 5's margins:
# SUCCESS share 0.098-0.249, median |depth - GT| 0.602-1.159 on SUCCESS
# pixels, cos(t_est, t_gt) 0.798-0.929.
RECT_GATES = dict(success=0.5 * 0.098, err=1.25 * 1.159, cos=0.798 - 0.1)


class SearchCapture:
    """While active, records (clones of) the inputs of every ssd_search
    call the main path makes in ``calls``.  sweep.py calls ssd_search as
    its module's global and sweep_rect.py under the name it imported, so
    both names are replaced for the duration by a callable that records
    and calls the real function; the main path's code is untouched.  The
    real function counts its launches on ``ssd_search.launches``, a
    lookup of its module's global, so the callable forwards that
    attribute."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        import tadataka_torch.vo.semi_dense.sweep as sweep
        import tadataka_torch.vo.semi_dense.sweep_rect as sweep_rect
        self._modules = (sweep, sweep_rect)
        self._real = sweep.ssd_search
        recording = _Recording(self._real, self.calls)
        for module in self._modules:
            module.ssd_search = recording
        return self

    def __exit__(self, *exc):
        for module in self._modules:
            module.ssd_search = self._real


class _Recording:
    """ssd_search that first clones its inputs into ``calls``."""

    def __init__(self, real, calls):
        self._real = real
        self._calls = calls

    def __call__(self, V, K, mlo, mhi):
        self._calls.append(tuple(x.clone() for x in (V, K, mlo, mhi)))
        return self._real(V, K, mlo, mhi)

    @property
    def launches(self):
        return self._real.launches

    @launches.setter
    def launches(self, n):
        self._real.launches = n


def drive(phase, frames, vo, device):
    """Drive ``vo.estimate`` over the frames with ssd_search's count at 0
    before and read after; log the plans and the quality, check the maps
    are finite and that the bootstrap frame improved the initial map,
    then make the last frame's update again from its inputs.  Returns
    (states, launches, plans of frames 1..n-1, quality, the ssd_search
    inputs of the last frame's update)."""
    from tadataka_torch.flags import Flag
    from tadataka_torch.vo.semi_dense.sweep import ssd_search
    last_inputs = {}

    def keep_last_inputs(k):
        if k == len(frames) - 1:
            last_inputs.update(prev=vo.state, prev_image=vo._prev_image,
                               refs=tuple(vo.refframes[-vo.history_size:]))

    used = []                       # the plan of each frame, as planned
    plan_fn = vo._plan
    vo._plan = lambda key_T: used.append(plan_fn(key_T)) or used[-1]
    ssd_search.launches = 0
    states = run_sequence(frames, vo, before=keep_last_inputs)
    launches = ssd_search.launches

    plans = [p for _, p in vo.metrics.frames]
    log(phase, f"{tuple(frames[0].depth_map.shape)}, {len(frames)} frames;"
        " plans: " + ", ".join(
            f"{p['plan_path']}/{p['plan_n_planes']}" for p in plans)
        + f"; ssd_search launches {launches}")
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
    log(phase, f"initial map: median |depth - GT| {init_err:.3f}; "
        f"bootstrap frame: SUCCESS share {boot_success:.3f}, median "
        f"|depth - GT| {boot_err:.4f}; last frame: SUCCESS share "
        f"{success:.3f}, median |depth - GT| {err:.4f}, cos(t_est, t_gt) "
        f"{cos:.4f}")
    log(phase, f"last frame's flags: {shares}")
    assert boot_err < 0.25 * init_err, (boot_err, init_err)
    searches = last_update(phase, vo, frame=frames[-1], device=device,
                           plan=used[-1] if used else None, **last_inputs)
    return states, launches, plans, (success, err, cos), searches


def check_gates(quality, gates):
    success, err, cos = quality
    assert (success > gates["success"] and err < gates["err"]
            and cos > gates["cos"]), (quality, gates)


def phase_slice(device="cuda", shape=VGA, focal=VGA_FOCAL):
    """The slice at full size on phase 5's trajectory, where the planner
    picks the homography sweep on every frame, with the quality gates.  Frames are rendered on the CPU, as a camera delivers them to
    the host."""
    from tadataka_torch.dataset import multi_plane_scene
    ds = multi_plane_scene(N_FRAMES, shape, (focal, focal),
                           trajectory(N_FRAMES))
    frames = [ds[i] for i in range(N_FRAMES)]
    vo = make_vo(shape, focal, device, metrics=PlanLog())
    _, launches, plans, quality, searches = drive("slice", frames, vo, device)
    n_updates = N_FRAMES - 1
    assert [p["plan_path"] for p in plans] == ["tent"] * n_updates, plans
    assert launches == n_updates, (launches, n_updates)
    assert len(searches) == 1, len(searches)
    check_gates(quality, SLICE_GATES)
    return launches, searches


def phase_rect(device="cuda", shape=VGA, focal=VGA_FOCAL):
    """SemiDenseVO at full size on a lateral trajectory (LATERAL: 0.1 m a
    frame before 8-10 m planes): one ssd_search launch per refframe of a
    rect frame, one per tent frame.  This forces the planner: the host
    pose chain drains only after the last frame, so the planner reads
    the constant-velocity prediction from the exact bootstrap pose,
    which on this trajectory is the true pose, and plans the rectified
    sweep from frame 2 on.  The app with its default drain does not
    reach `rect` here: DVO falls short of the lateral motion, and
    drained estimates send the planner back to the homography sweep.
    Gated by RECT_GATES on the last frame; the SUCCESS share of every
    frame is printed."""
    from tadataka_torch.dataset import multi_plane_scene
    n = N_RECT_FRAMES
    ds = multi_plane_scene(n, shape, (focal, focal), trajectory(n, **LATERAL))
    frames = [ds[i] for i in range(n)]
    vo = make_vo(shape, focal, device, metrics=PlanLog())
    vo.pose_drain_interval = n
    states, launches, plans, quality, searches = drive("rect", frames, vo,
                                                       device)
    log("rect", f"SUCCESS share per frame (frames 1-{n - 1}): " + ", ".join(
        f"{p['plan_path']} {(s.flag_map == 0).float().mean().item():.3f}"
        for s, p in zip(states[1:], plans)))
    paths = [p["plan_path"] for p in plans]
    steady = paths[2:]
    assert steady.count("rect") > len(steady) // 2, paths
    expected = sum(min(k, vo.history_size) if path == "rect" else 1
                   for k, path in enumerate(paths, start=1))
    assert launches == expected, (launches, expected, paths)
    assert paths[-1] == "rect" and len(searches) == min(
        n - 1, vo.history_size), (paths, len(searches))
    check_gates(quality, RECT_GATES)
    return launches, searches


def phase_captured(searches):
    """The ssd_search inputs of one steady frame of the tent and the rect
    drive, as the main path gave them: ssd_search bit-equal to the plain
    version on each, and per search and per frame its time beside the
    plain version's and the bound at those inputs.  The probes run on the
    same inputs (ssd_serial bit-equal, ssd_par within bounds), the
    windows ssd_serial re-scores exactly where it runs "tile" are
    counted, and the probes are timed there in turns.  Returns {path:
    frame totals}."""
    from tadataka_torch.probes import exp_ssd as probes
    from tadataka_torch.vo.semi_dense.sweep import ssd_window_bounds
    log_clocks("captured", "before")
    totals = {}
    for path, calls in searches.items():
        frame = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
        rescore = torch.zeros(3, dtype=torch.int64, device="cuda")
        windows = pixels = tiled = 0
        par_equal = True
        census = {}
        probe_ms = {"ssd_serial": 0.0, "ssd_par": 0.0}
        for i, args in enumerate(calls):
            name = f"the {path} frame's search {i}"
            ref = check_search(name, args)
            tile = probes.serial_design(args[0].shape[0]) == "tile"
            tiled += tile
            out = probes.ssd_serial(*args, rescore=rescore if tile else None)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(out, ref)):
                raise AssertionError(f"ssd_serial differs from plain on "
                                     f"{name}")
            par_equal &= compare_search(
                f"ssd_par on {name}", probes.ssd_par(*args),
                probes.ssd_par_reference(*args))[0]
            for key, n in probes.filter_census(*args).items():
                census[key] = census.get(key, 0) + n
            lo, hi = (x.long() for x in ssd_window_bounds(
                args[2], args[3], args[0].shape[0]))
            windows += torch.clamp(hi - lo + 1, min=0).sum().item()
            pixels += lo.numel()
            r = time_search("captured", f"{path} frame, search {i} of "
                            f"{len(calls)} (bit-equal to plain)", args)
            for key in frame:
                frame[key] += r[key]
            times = probes.cuda_times({
                "ssd_serial": lambda: probes.ssd_serial(*args),
                "ssd_par": lambda: probes.ssd_par(*args)})
            for key, t in times.items():
                probe_ms[key] += statistics.median(t)
        n_exact, n_scan, n_sweep = rescore.tolist()
        census["candidates"] /= len(calls)
        log("captured", f"{path} frame, {len(calls)} searches, ssd_serial "
            f"bit-equal to plain (tile on {tiled}), ssd_par "
            f"{'bit-equal to plain' if par_equal else 'within bounds'}"
            + (f": tile re-scored {n_exact / pixels:.3f} windows a pixel "
               f"exactly of {windows / pixels:.3f} in bounds, {n_scan} of "
               f"{pixels} pixels scanned every window, {n_sweep} swept "
               "again for several candidates" if tiled == len(calls) else
               f"; {windows / pixels:.3f} windows a pixel in bounds")
            + f"; the plain filter's census (pixels): {census}; the probes "
            "on these searches, in turns, medians summed: " + ", ".join(
                f"{name} {ms:.4f} ms" for name, ms in probe_ms.items()))
        log("captured", f"{path} frame, {len(calls)} searches: ssd_search "
            f"{frame['ms']:.4f} ms, plain {frame['plain_ms']:.4f} ms, bound "
            f"at these inputs {frame['bound_ms']:.4f} ms "
            f"({frame['bound_ms'] / frame['ms']:.3f} of it)")
        totals[path] = frame
    log_clocks("captured", "after")
    return totals


def phase_scatter(device="cuda", shape=VGA, focal=VGA_FOCAL):
    """SemiDenseVO(depth_update="scatter") at full size on phase 5's
    trajectory: the scattered estimator on every frame, which launches
    no SSD kernel."""
    from tadataka_torch.dataset import multi_plane_scene
    n = N_SCATTER_FRAMES
    ds = multi_plane_scene(n, shape, (focal, focal), trajectory(n))
    frames = [ds[i] for i in range(n)]
    vo = make_vo(shape, focal, device, metrics=PlanLog(),
                 depth_update="scatter")
    _, launches, plans, _, _ = drive("scatter", frames, vo, device)
    assert [p["plan_path"] for p in plans] == ["scatter"] * (n - 1), plans
    assert launches == 0, launches


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
    states = run_sequence(frames, vo)
    success, err, cos = depth_and_pose_quality(states[-1], frames[-1])
    log("app-gate", f"80x100, 5 frames: plans "
        f"{[p['plan_path'] for _, p in plans.frames]}, SUCCESS share "
        f"{success:.3f}, median |depth - GT| {err:.4f}, cos(t_est, t_gt) "
        f"{cos:.4f}")
    if torch.device(device).type == "cuda":
        assert ssd_search.launches - before == 4
    assert success > 0.2 and err < 1.0 and cos > 0.9, (success, err, cos)


# The JAX package's estimate_depth_from_stereo on the stereo phase's pair
# (tools/stereo_vs_jax.py, on the CPU): valid share 0.2859, median
# |depth - GT| 0.003343 m on valid pixels; on the euroc phase's export,
# frame 0 at max_disparity 64: valid share 0.7689, median 0.05115 m.
# Gated as phase 5 is: half the reference's share, 1.25 x its error.
STEREO_GATES = dict(valid=0.5 * 0.2859, err=1.25 * 0.003343)
EUROC_GATES = dict(valid=0.5 * 0.7689, err=1.25 * 0.05115)
# The JAX PipelinedSemiDenseVO (both stages on one device) on phase 5's
# trajectory and parameters at 1/4 and 1/2 size, random initial map
# (tools/slice_vs_jax.py --app pipelined), last frame after flush_map:
# SUCCESS share 0.0987-0.1493, median |depth - GT| 1.138-1.165 on
# SUCCESS pixels, cos(t_est, t_gt) 0.609-0.695; phase 5's margins.
PIPELINED_GATES = dict(success=0.5 * 0.0987, err=1.25 * 1.165,
                       cos=0.609 - 0.1)


def stereo_readings(depth, valid, gt):
    """(valid share, median |depth - GT| on valid pixels)."""
    valid = valid.cpu().numpy()
    err = np.abs(depth.cpu().numpy() - np.asarray(gt))[valid]
    return float(valid.mean()), float(np.median(err))


def stereo_cpu_vs_card(phase, params, left, right, baseline, **args):
    """match_stereo and depth on the CPU and on the card on the same
    pair, held equal bit for bit; returns the card's (depth, valid)."""
    from tadataka_torch.vo.stereo import (
        depth_from_disparity, estimate_depth_from_stereo, match_stereo)
    fx = params.focal_length[0]
    out = []
    for device in ("cpu", "cuda"):
        disp, valid = match_stereo(left.to(device), right.to(device), **args)
        out.append((disp, valid,
                    depth_from_disparity(disp, fx.to(device), baseline)))
    for name, a, b in zip(("disparity", "valid", "depth"), *out):
        assert torch.equal(a, b.cpu()), (phase, name)
    depth, valid = estimate_depth_from_stereo(params, left, right, baseline,
                                              **args)
    assert torch.equal(depth.cpu(), out[0][2]) and torch.equal(
        valid.cpu(), out[0][1])
    log(phase, f"{tuple(left.shape)}, max_disparity "
        f"{args['max_disparity']}: disparity, valid mask and depth "
        "bit-equal on the CPU and the card")
    return depth, valid


def phase_stereo(smi):
    """estimate_depth_from_stereo on the card at 480x640 and 128
    disparities (bench.py's NewTsukuba setting) on phase 5's scene seen
    by a rectified pair: bit-equal to the CPU, gated by STEREO_GATES on
    the valid share and the depth error, timed by CUDA events."""
    from tadataka_torch.probes.exp_ssd import cuda_times
    from tadataka_torch.vo.stereo import estimate_depth_from_stereo
    params, left, right, gt = stereo_pair()
    args = dict(max_disparity=STEREO_MAX_DISPARITY, radius=STEREO_RADIUS)
    depth, valid = stereo_cpu_vs_card("stereo", params, left, right,
                                      STEREO_BASELINE, **args)
    share, err = stereo_readings(depth, valid, gt)
    log("stereo", f"valid share {share:.4f} (gate > "
        f"{STEREO_GATES['valid']:.4f}), median |depth - GT| on valid pixels "
        f"{err:.6f} m (gate < {STEREO_GATES['err']:.6f}; planes at 5.6-9.3 "
        "m)")
    assert share > STEREO_GATES["valid"] and err < STEREO_GATES["err"], (
        share, err)
    cam = type(params)(*(x.cuda() for x in params))
    left_c, right_c = left.cuda(), right.cuda()
    torch.cuda.reset_peak_memory_stats()
    times = cuda_times({"stereo": lambda: estimate_depth_from_stereo(
        cam, left_c, right_c, STEREO_BASELINE, **args)}, repeats=10)
    ms = statistics.median(times["stereo"])
    log("stereo", f"estimate_depth_from_stereo 480x640, 128 disparities, "
        f"r=3: {ms:.3f} ms (CUDA-event median of 10, L2 flushed; {smi}); "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.0f}"
        " MiB")
    return ms


def write_new_tsukuba(root, n=3):
    """A NewTsukuba tree of ``n`` 480x640 stereo frames (the stereo
    phase's pair as RGBA PNGs through the port's codec, its left depth
    as OpenCV XML for both sides, a camera track): returns the images
    and depth written."""
    from tadataka_torch.dataset import imsave
    _, left, right, gt = stereo_pair()
    gt = np.round(gt.numpy().astype(np.float64), 3)
    images = []
    for side, image in (("left", left), ("right", right)):
        u8 = np.clip(image.numpy() * 255.0, 0, 255).astype(np.uint8)
        rgba = np.stack([u8, u8, u8, np.full_like(u8, 255)], axis=-1)
        images.append(rgba)
        ill = Path(root, "illumination", "daylight", side)
        xml = Path(root, "groundtruth", "depth_maps", side)
        ill.mkdir(parents=True)
        xml.mkdir(parents=True)
        rows = "\n".join(" ".join(f"{v:.3f}" for v in row) for row in gt)
        text = ("<opencv_storage><depth type_id=\"opencv-matrix\">"
                f"<rows>{gt.shape[0]}</rows><cols>{gt.shape[1]}</cols>"
                f"<dt>f</dt><data>{rows}</data></depth></opencv_storage>")
        for i in range(n):
            imsave(ill / f"frame_{i:05d}.png", rgba)
            (xml / f"frame_{i:05d}.xml").write_text(text)
    Path(root, "groundtruth", "camera_track.txt").write_text("\n".join(
        f"{10.0 * i},0,0,0,{2.0 * i},0" for i in range(n)))
    return images, gt


def phase_euroc(smi):
    """The port's export_euroc_scene at EuRoC's 480x752, 5 frames, read
    back by EurocDataset (sensor.yaml through the port's reader, PNGs
    through its codec): tests/realdata/test_euroc_e2e.py's checks, and
    stereo depth of frame 0 at 64 disparities on the card, bit-equal to
    the CPU and gated by EUROC_GATES against debug_gt.  Then a
    NewTsukuba tree written with the port's codec and read back by
    NewTsukubaDataset."""
    from tadataka_torch.dataset import (
        EurocDataset, NewTsukubaDataset, export_euroc_scene)
    from tadataka_torch.probes.exp_ssd import cuda_times
    from tadataka_torch.vo.stereo import estimate_depth_from_stereo
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        export_euroc_scene(root, n_frames=N_EUROC_FRAMES,
                           image_shape=EUROC_SHAPE)
        t_export = time.perf_counter() - t0
        t0 = time.perf_counter()
        ds = EurocDataset(root)
        f0, f1 = ds[0]
        t_load = time.perf_counter() - t0
        assert len(ds) == N_EUROC_FRAMES, len(ds)
        assert tuple(f0.image.shape) == EUROC_SHAPE, f0.image.shape
        assert torch.allclose(f0.pose.R, f1.pose.R, atol=1e-6)
        coeffs = f0.camera_model.distortion_model.dist_coeffs
        assert torch.allclose(coeffs[:2], torch.tensor([-0.08, 0.01]),
                              atol=1e-7), coeffs
        g0, g1, baseline = euroc_stereo(f0, f1)
        assert abs(baseline - 0.11) <= 0.11 * 1e-5, baseline
        gt = np.load(Path(root, "debug_gt", "0.npz"))["depth"]
        params = f0.camera_model.camera_parameters
        args = dict(max_disparity=EUROC_MAX_DISPARITY, radius=STEREO_RADIUS)
        depth, valid = stereo_cpu_vs_card("euroc", params, g0, g1, baseline,
                                          **args)
    share, err = stereo_readings(depth, valid, gt)
    cam = type(params)(*(x.cuda() for x in params))
    g0, g1 = g0.cuda(), g1.cuda()
    times = cuda_times({"euroc": lambda: estimate_depth_from_stereo(
        cam, g0, g1, baseline, **args)}, repeats=10)
    stereo_ms = statistics.median(times["euroc"])
    log("euroc", f"{N_EUROC_FRAMES} frames at {EUROC_SHAPE[0]}x"
        f"{EUROC_SHAPE[1]} exported in {t_export:.1f} s, loader and frame 0 "
        f"{t_load:.2f} s; baseline {baseline:.6f} m, RadTan "
        f"{coeffs.tolist()}; stereo depth of frame 0: valid share "
        f"{share:.4f} (gate > {EUROC_GATES['valid']:.4f}), median |depth - "
        f"GT| {err:.5f} m (gate < {EUROC_GATES['err']:.5f}), "
        f"{stereo_ms:.3f} ms (CUDA-event median of 10, L2 flushed; {smi})")
    assert share > EUROC_GATES["valid"] and err < EUROC_GATES["err"], (
        share, err)
    with tempfile.TemporaryDirectory() as root:
        images, gt = write_new_tsukuba(root)
        t0 = time.perf_counter()
        ds = NewTsukubaDataset(root)
        t_cache = time.perf_counter() - t0
        left, right = ds[2]
        assert len(ds) == 3
        for frame, image in zip((left, right), images):
            assert np.array_equal(frame.image.numpy(), image[..., :3])
            assert np.array_equal(frame.depth_map.numpy(), gt)
        offset = float(torch.linalg.norm(right.pose.t - left.pose.t))
        assert abs(offset - NewTsukubaDataset.BASELINE) < 1e-4, offset
    log("euroc", f"NewTsukuba tree of 3 480x640 frames (RGBA PNGs, XML "
        f"depth) read back: images and depth equal, baseline {offset:.5f};"
        f" first load with its caches {t_cache:.2f} s")


def make_pipelined(shape, focal, device, **overrides):
    from tadataka_torch.apps import PipelinedSemiDenseVO
    from tadataka_torch.camera import CameraParameters
    from tadataka_torch.vo.semi_dense import SemiDenseParams
    H, W = shape
    return PipelinedSemiDenseVO(
        CameraParameters.create((focal, focal), (W / 2.0, H / 2.0)),
        params=SemiDenseParams.create(2.0, 50.0, ref_step_size=0.002,
                                      min_gradient=0.01),
        devices=(device, device), **dict(SLICE_ARGS, **overrides))


def run_pipelined(frames, vo):
    """Drive the pipelined app over the frames (bootstrap with the true
    pose) and flush; returns the states: state k is frame k - 1's (frame
    0's for k < 2), the last the flushed one."""
    vo.initial_pose_fn = lambda image0, image1: (
        frames[1].pose.inv() * frames[0].pose)
    return [vo.estimate(frame) for frame in frames] + [vo.flush_map()]


def phase_pipelined():
    """PipelinedSemiDenseVO on the card: the CPU-against-card check of
    every state at 120x160 over 5 frames (torch.equal; a missing stream
    wait shows here), then phase 5's 12 frames at 480x640 with
    ssd_search's count at 0 before and read after, gated by
    PIPELINED_GATES on the flushed last frame.  Returns the launches."""
    from tadataka_torch.dataset import multi_plane_scene
    from tadataka_torch.vo.semi_dense.sweep import ssd_search
    c = PIPELINED_CHECK
    ds = multi_plane_scene(c["frames"], c["shape"], (c["focal"],) * 2,
                           trajectory(c["frames"], step=(0.12, 0.01, 0.1)))
    frames = [ds[i] for i in range(c["frames"])]
    runs = []
    for device in ("cpu", "cuda"):
        states = run_pipelined(frames, make_pipelined(
            c["shape"], c["focal"], device))
        runs.append([[None if x is None else x.cpu() for x in (
            s.pose_wc.R, s.pose_wc.t, s.depth_map, s.variance_map,
            s.age_map, s.flag_map)] for s in states])
    for k, (a, b) in enumerate(zip(*runs)):
        assert all((x is None and y is None) or torch.equal(x, y)
                   for x, y in zip(a, b)), f"state {k} differs"
    log("pipelined", f"{c['shape'][0]}x{c['shape'][1]}, {c['frames']} "
        f"frames + flush: all {len(runs[0])} states (pose, depth, "
        "variance, age, flags) bit-equal on the CPU and the card")

    ds = multi_plane_scene(N_FRAMES, VGA, (VGA_FOCAL, VGA_FOCAL),
                           trajectory(N_FRAMES))
    frames = [ds[i] for i in range(N_FRAMES)]
    vo = make_pipelined(VGA, VGA_FOCAL, "cuda", metrics=PlanLog())
    ssd_search.launches = 0
    states = run_pipelined(frames, vo)
    launches = ssd_search.launches
    last = states[-1]
    for x in (last.depth_map, last.variance_map, last.pose_wc.t):
        assert bool(torch.isfinite(x).all())
    success, err, cos = depth_and_pose_quality(last, frames[-1])
    paths = [p["plan_path"] for _, p in vo.metrics.frames]
    log("pipelined", f"480x640, {N_FRAMES} frames + flush: plans {paths}; "
        f"ssd_search launches {launches}")
    log("pipelined", f"last frame (flushed): SUCCESS share {success:.3f} "
        f"(gate > {PIPELINED_GATES['success']:.4f}), median |depth - GT| "
        f"{err:.4f} (< {PIPELINED_GATES['err']:.4f}), cos(t_est, t_gt) "
        f"{cos:.4f} (> {PIPELINED_GATES['cos']:.4f})")
    assert paths == ["tent"] * (N_FRAMES - 1), paths
    assert launches == N_FRAMES - 1, launches
    check_gates((success, err, cos), PIPELINED_GATES)
    return launches


UPDATE_INPUTS = {}   # phase -> the inputs of its last frame's update


def last_update(phase, vo, prev, prev_image, refs, frame, device, plan):
    """The update of one steady-state frame made again by the port's
    stage functions from that frame's inputs, with the app's plan of
    that frame (None: the scattered estimator).  Keeps the update's
    inputs in UPDATE_INPUTS[phase] and returns the inputs of every
    ssd_search call it made."""
    from tadataka_torch.apps.semi_dense_vo import (
        prepare_image, track, propagate_step, update, to_gray_f32)
    from tadataka_torch.core.rounding import matmul_small
    from tadataka_torch.core.transforms import inv_motion_matrix
    image = to_gray_f32(prepare_image(frame, device))
    cam = vo.camera_params
    T10 = track(vo._camera_model, prev_image, prev.depth_map,
                prev.variance_map, image, vo.n_coarse_to_fine)
    d1, v1, age1 = propagate_step(
        cam, T10, prev.depth_map, prev.variance_map, prev.age_map,
        vo.default_depth, vo.default_variance, vo.uncertainty_bias)
    T_wk = matmul_small(prev.pose_wc.T, inv_motion_matrix(T10))
    UPDATE_INPUTS[phase] = dict(cam=cam, params=vo.params, image=image,
                                T_wk=T_wk, refs=refs, age=age1, depth=d1,
                                variance=v1, plan=plan)
    with SearchCapture() as capture:
        update(cam, vo.params, image, T_wk, refs, age1, d1, v1, plan, False,
               vo.fuse_prior, vo.n_ref_samples)
    return capture.calls


def gather_hard_case(shape, S=None, seed=11):
    """Uniform image and indices in [-2n, 2n) on the card, the first six
    planted at -n - 1, -n, -1, 0, n - 1, n (n the gathered length):
    (img, rows, cols) for the axis gathers, or (img, idx (S, H*W)) for
    the flat ones."""
    gen = np.random.default_rng(seed)
    H, W = shape
    img = torch.tensor(gen.random((H, W)), dtype=torch.float32,
                       device="cuda")

    def indices(n, size):
        idx = gen.integers(-2 * n, 2 * n, size).astype(np.int32)
        idx.reshape(-1)[:6] = [-n - 1, -n, -1, 0, n - 1, n]
        return torch.tensor(idx, device="cuda")

    if S is not None:
        return img, indices(H * W, (S, H * W))
    return img, indices(H, (H, W)), indices(W, (H, W))


def sass_sections(built, kernel):
    """(header, SASS lines) of every function of a built library whose
    name holds ``kernel`` (each instance of a template), from the
    toolkit's cuobjdump."""
    from torch.utils.cpp_extension import CUDA_HOME
    tool = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(built.path)],
                          capture_output=True, text=True,
                          check=True).stdout
    return [(x.split("\n", 1)[0], x.splitlines())
            for x in sass.split("Function : ")
            if kernel in x.split("\n", 1)[0]]


def kernel_sass(built, kernel):
    """The SASS lines of the first function named ``kernel``."""
    return sass_sections(built, kernel)[0][1]


def loop_per_window(lines, marker="MUFU.RSQ"):
    """(instructions a window, windows a trip) of the innermost loop of a
    SASS listing whose body holds the most ``marker`` instructions, one a
    window: the lines from a backward branch's target to the branch."""
    import re
    ops, labels, pending = [], {}, []
    for line in lines:
        label = re.match(r"\s*(\.L_x_\d+):", line)
        if label:
            pending.append(label.group(1))
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(\S.*?);", line)
        if m:
            addr = int(m.group(1), 16)
            labels.update(dict.fromkeys(pending, addr))
            pending = []
            ops.append((addr, m.group(2)))
    loops = []
    for addr, text in ops:
        if "BRA" not in text:
            continue
        hexa = re.search(r"0x([0-9a-f]+)", text)
        name = re.search(r"(\.L_x_\d+)", text)
        target = (int(hexa.group(1), 16) if hexa else
                  labels.get(name.group(1)) if name else None)
        if target is not None and target <= addr:
            loops.append((target, addr))
    best = (0, 0)
    for lo, hi in loops:
        if any(lo <= a and b <= hi and (a, b) != (lo, hi) for a, b in loops):
            continue                           # not innermost
        body = [text for addr, text in ops if lo <= addr <= hi]
        n = sum(marker in text for text in body)
        if n > best[1] or (n == best[1] and len(body) < best[0]):
            best = (len(body), n)
    return (best[0] / best[1], best[1]) if best[1] else (None, 0)


def phase_gather(floor_gbs):
    """The gather probes' entry points (``python -m tadataka_torch.probes.
    dynamic_gather`` and ``flat_gather`` do the same) with every launch
    count at 0 before them; each kernel bit-equal to its plain version
    (NaN in the same places) on the scripts' inputs there and here on
    the hard case (planted negative, out-of-range and edge indices, 479 x
    641, 480 x 640 and 2000 x 9, 20 index rows of H*W), take_along_axis1
    and flat_take also by their first kernels (flat_take runs its first
    kernel at 479 x 641, whose H*W % 4 is not 0, and "band" takes a tail
    of S*N % 4 = 1 at 480 x 640; take_along_axis0 and multi_warp run
    theirs at 2000 x 9, where a column strip passes 227 KB); then each
    kernel's time beside its plain version's, its library call's, its
    bound and the card's launch floor (an empty kernel), take_along_axis1
    and flat_take beside their first kernels timed in turns (with their
    library calls), the SASS of the kernels (loads, and instructions a
    slot a band of "band"), and flat_take_rows beside torch.take and its
    time on identity indices.  Returns the kernels' JSON entries."""
    from tadataka_torch.probes import dynamic_gather, flat_gather
    from tadataka_torch.probes import gather as g
    from tadataka_torch.probes.exp_ssd import cuda_ms
    for fn in g.WRAPPERS:
        fn.launches = 0
    log_clocks("gather", "before")
    dyn = dynamic_gather.run(log=lambda line: log("gather", line))
    flat = flat_gather.run(log=lambda line: log("gather", line))
    log_clocks("gather", "after")
    launches = {fn.__name__: fn.launches for fn in g.WRAPPERS}
    log("gather", f"launches in the probe run: {launches}")
    assert all(n > 0 for n in launches.values()), launches
    timed = {**{k: dyn[k] for k in ("take_along_axis0", "take_along_axis1",
                                    "multi_warp")},
             **{k: flat[k] for k in ("flat_take", "flat_take_rows")}}
    assert all(r["correct"] for r in (*dyn.values(), *flat.values())
               if isinstance(r, dict)), (dyn, flat)

    for shape in ((479, 641), VGA, (2000, 9)):
        img, rows, cols = gather_hard_case(shape)
        fimg, idx = gather_hard_case(shape, S=20)
        checks = {
            "take_along_axis0": (g.take_along_axis0(img, rows),
                                 g.take_along_axis_reference(img, rows, 0)),
            "take_along_axis1": (g.take_along_axis1(img, cols),
                                 g.take_along_axis_reference(img, cols, 1)),
            "take_along_axis1/thread": (
                g.first_kernel(g.take_along_axis1, img, cols),
                g.take_along_axis_reference(img, cols, 1)),
            "multi_warp": (g.multi_warp(img, rows, cols, 16),
                           g.multi_warp_reference(img, rows, cols, 16)),
            "flat_take": (g.flat_take(fimg, idx),
                          g.flat_take_reference(fimg, idx)),
            "flat_take/thread": (g.first_kernel(g.flat_take, fimg, idx),
                                 g.flat_take_reference(fimg, idx)),
            "flat_take_rows": (g.flat_take_rows(fimg, idx),
                               g.flat_take_rows_reference(fimg, idx))}
        torch.cuda.synchronize()
        nans = {}
        for name, (out, ref) in checks.items():
            assert g.same_bits(out, ref), (name, shape)
            nans[name] = f"{torch.isnan(ref).float().mean().item():.3f}"
        tail = idx[:7, :1003].contiguous()    # S*N % 4 == 1
        assert g.same_bits(g.flat_take(fimg, tail),
                           g.flat_take_reference(fimg, tail)), shape
        log("gather", f"hard case {shape[0]}x{shape[1]} (flat: 20 x "
            f"{shape[0] * shape[1]} indices, and 7 x 1003 for flat_take; "
            f"flat_take runs {'thread' if fimg.numel() % 4 else 'band'}): "
            "all five and both first kernels bit-equal to their plain "
            f"versions, NaN in the same places (NaN share {nans})")

    img, rows, cols = dynamic_gather.probe_inputs()
    fimg, idx = flat_gather.probe_inputs()
    S, N = idx.shape
    plain = {
        "take_along_axis0": cuda_ms(
            lambda: g.take_along_axis_reference(img, rows, 0)),
        "take_along_axis1": cuda_ms(
            lambda: g.take_along_axis_reference(img, cols, 1)),
        "multi_warp": cuda_ms(lambda: g.multi_warp_reference(
            img, rows, cols, dynamic_gather.S)),
        "flat_take": cuda_ms(lambda: g.flat_take_reference(fimg, idx)),
        "flat_take_rows": cuda_ms(
            lambda: g.flat_take_rows_reference(fimg, idx))}
    built = g.gather_library()
    one_warp = cuda_ms(lambda: g.multi_warp(img, rows, cols, 1))
    ratio = dyn["multi_warp"]["ms"] / one_warp
    log("gather", f"multi_warp S=1: {one_warp * 1e3:.2f} us; "
        f"S={dynamic_gather.S} takes {ratio:.2f}x as long")
    assert ratio > 3.0, "multi_warp: the gathers were hoisted out of its loop"
    for kernel in ("multi_warp_kernel", "multi_warp_strip_kernel",
                   "take_axis0_kernel", "take_axis0_strip_kernel",
                   "take_axis1_kernel", "take_axis1_row_kernel",
                   "flat_take_kernel", "flat_take_band_kernel"):
        for header, body in sass_sections(built, kernel):
            form = ("" if "ILb" not in header else " (16-byte staging)"
                    if "ILb1" in header else " (plain-load staging)")
            log("gather", f"SASS of {kernel}{form}: "
                f"{sum('LDG' in line for line in body)} global loads (LDG), "
                f"{sum('LDS' in line for line in body)} shared loads (LDS), "
                f"{sum('LDGSTS' in line for line in body)} of the LDG "
                "cp.async copies (LDGSTS)")
    clean = {name: cuda_ms(fn, clean=True) for name, fn in (
        ("take_along_axis0", lambda: g.take_along_axis0(img, rows)),
        ("torch.gather", lambda: torch.gather(img, 0, rows)),
        ("launch floor", g.empty_launch))}
    log("gather", "with a clean L2 (flushed by a read, no dirty lines to "
        "write back): " + ", ".join(f"{name} {ms * 1e3:.2f} us"
                                    for name, ms in clean.items()))
    body = sass_sections(built, "flat_take_band_kernel")[0][1]
    at = [i for i, line in enumerate(body) if "LDS" in line]
    log("gather", f"SASS of flat_take_band_kernel: {len(at)} shared loads "
        f"(LDS), {(at[-1] - at[0] + 1) / len(at):.2f} instructions a slot a "
        "band between the first and the last (the unrolled slot loop), "
        f"{sum('UBLKCP' in line for line in body)} bulk copies (UBLKCP)")
    plane = VGA[0] * VGA[1] * 4
    floor = dyn["launch_floor"]
    kernels = {"take_along_axis0": ["take_along_axis0"],
               "take_along_axis1": ["take_along_axis1",
                                    "take_along_axis1/thread"],
               "multi_warp": ["multi_warp"]}
    library = {"take_along_axis0": "gather0", "take_along_axis1": "gather1"}
    for name in ("take_along_axis0", "take_along_axis1", "multi_warp"):
        n_bytes = (4 if name == "multi_warp" else 3) * plane
        bound_ms = 1e3 * bound_s(n_bytes, 0)
        log("gather", f"{name} in turns: " + ", ".join(
                f"{d} {dyn[d]['ms'] * 1e3:.2f} us (quartiles "
                + " - ".join(f"{q * 1e3:.2f}" for q in dyn[d]["quartiles"])
                + ")" for d in kernels[name])
            + f"; plain {plain[name] * 1e3:.2f} us, library "
            + (f"{dyn[library[name]] * 1e3:.2f} us (torch.gather)"
               if name in library else "none")
            + f", bound {bound_ms * 1e3:.2f} us, launch floor (empty "
            f"kernel) {floor * 1e3:.2f} us")
    flat_bytes = plane + 2 * S * N * 4
    log("gather", "flat_take in turns: " + ", ".join(
        f"{d} {flat[d]['ms']:.4f} ms (quartiles "
        + " - ".join(f"{q:.4f}" for q in flat[d]["quartiles"]) + ")"
        for d in ("flat_take", "flat_take/thread"))
        + f", torch.take {flat['take']:.4f} ms; plain "
        f"{plain['flat_take']:.4f} ms, bound "
        f"{1e3 * bound_s(flat_bytes, 0):.4f} ms")
    rows_ms = timed["flat_take_rows"]["ms"]
    log("gather", f"flat_take_rows: {rows_ms:.4f} ms against torch.take "
        f"{flat['take']:.4f} ms ("
        f"{'no slower' if rows_ms <= flat['take'] else 'slower'}, "
        f"{rows_ms / flat['take']:.3f}x) and flat_take "
        f"{timed['flat_take']['ms']:.4f} ms; on identity indices "
        f"{flat['identity']['ms']:.4f} ms, on indices 8 to a 32-byte "
        f"sector {flat['sector']['ms']:.4f} ms")
    work = {"take_along_axis0": (3 * plane, 0, dyn["gather0"]),
            "take_along_axis1": (3 * plane, 0, dyn["gather1"]),
            "multi_warp": (4 * plane, 2 * dynamic_gather.S * plane // 4,
                           None),
            "flat_take": (plane + 2 * S * N * 4, 0, flat["take"]),
            "flat_take_rows": (plane + 2 * S * N * 4, 0, flat["take"])}
    entries = []
    for name, (n_bytes, flops, library_ms) in work.items():
        entry = kernel_entry(name, GATHER_SOURCE, GATHER_REPLACES[name],
                             launches[name], 0.0, timed[name]["ms"],
                             plain[name], n_bytes, flops, library_ms)
        floor_ms = n_bytes / floor_gbs / 1e6
        log("gather", f"{name}: kernel {entry['ms'] * 1e3:.2f} us, plain "
            f"{entry['plain_ms'] * 1e3:.2f} us, library "
            + ("none" if library_ms is None else f"{library_ms * 1e3:.2f} us")
            + f"; {n_bytes / 1e6:.2f} MB -> bound {entry['bound_ms'] * 1e3:.2f}"
            f" us at 3.35 TB/s ({entry['bound_ms'] / entry['ms']:.3f} of it "
            f"reached), {floor_ms * 1e3:.2f} us at the measured floor of "
            f"{floor_gbs:.1f} GB/s ({floor_ms / entry['ms']:.3f})")
        entries.append(entry)
    return entries


def dvo_pair(camera_model, shape):
    """Two frames of a plane through ``camera_model`` at ``shape``: (I0,
    D0, I1) on the CPU."""
    from tadataka_torch.core.pose import Pose
    from tadataka_torch.dataset.synthetic import render_plane_scene
    poses = [Pose.identity(),
             Pose.from_rotvec(torch.tensor([0.0, 0.01, 0.003]),
                              torch.tensor([0.05, 0.02, 0.03]))]
    (I0, D0), (I1, _) = [render_plane_scene(
        camera_model, pose, shape, plane_origin=(0.0, 0.0, 2.5),
        plane_normal=(0.06, -0.04, -1.0)) for pose in poses]
    return I0, D0, I1


def phase_dvo_cpu_gpu(tum_root, devices=("cpu", "cuda")):
    """DVO on the CPU and on the card on the same inputs, bit for bit:
    ``DvoTrajectory(weights="huber")`` over the first 3 frames of the TUM
    scene at 480x640; the forward-compositional pyramid on one 240x320
    pair through the freiburg1 camera (scaled by 1/2) with each weight
    kind; the RadTan grids; a FOV camera's normalize and unnormalize
    (``core.rounding``'s tan and atan)."""
    from tadataka_torch.apps import DvoTrajectory
    from tadataka_torch.camera import FOV, CameraModel, CameraParameters
    from tadataka_torch.camera import resize
    from tadataka_torch.dataset import TumRgbdDataset
    from tadataka_torch.vo.dvo import estimate_pose_pyramid, normalized_grids
    ds = TumRgbdDataset(tum_root, which_freiburg=1)
    frames = [ds[i] for i in range(3)]
    runs = []
    for device in devices:
        vo = DvoTrajectory(ds.camera_model, weights="huber", device=device)
        for frame in frames:
            vo.estimate(frame)
        runs.append(torch.stack([torch.cat([p.R.ravel(), p.t]).cpu()
                                 for p in vo.trajectory]))
    assert torch.equal(*runs), (runs[0] - runs[1]).abs().max()
    log("dvo-cpu-gpu", "DvoTrajectory(huber), 3 frames at 480x640: poses "
        f"bit-equal; position of frame 2 {runs[1][2, 9:].numpy()}")

    cm = resize(ds.camera_model, 0.5)
    I0, D0, I1 = dvo_pair(cm, (240, 320))
    grids = [normalized_grids(cm.to(d), 5, 1.5, (240, 320)) for d in devices]
    assert all(torch.equal(a.cpu(), b.cpu())
               for ga, gb in zip(*grids) for a, b in zip(ga, gb))
    for kind in ("none", "tukey", "student-t", "huber", "depth-var"):
        out = []
        for d, grid in zip(devices, grids):
            c = cm.to(d)
            R, t = estimate_pose_pyramid(
                c, c, I0.to(d), D0.to(d), I1.to(d),
                torch.ones_like(I0, device=d), torch.eye(3, device=d),
                torch.zeros(3, device=d), 5, 20, 1.5, kind, "fc", grid)
            out.append(torch.cat([R.ravel(), t]).cpu())
        assert torch.equal(*out), (kind, (out[0] - out[1]).abs().max())
        log("dvo-cpu-gpu", f"fc pyramid, 240x320, weights {kind}: pose "
            f"bit-equal, t10 {out[1][9:].numpy()}")
    log("dvo-cpu-gpu", "RadTan grids of the 5 levels bit-equal")

    us = torch.rand((20000, 2), generator=torch.Generator().manual_seed(0))
    us = us * torch.tensor([640.0, 480.0])
    fov = [CameraModel.create(CameraParameters.create(
        (517.3, 516.5), (318.6, 255.3), device=d), FOV.create(0.8, device=d))
        for d in devices]
    xs = [cam.normalize(us.to(cam.camera_parameters.offset.device)).cpu()
          for cam in fov]
    back = [cam.unnormalize(xs[0].to(cam.camera_parameters.offset.device))
            .cpu() for cam in fov]
    for name, (a, b) in (("normalize", xs), ("unnormalize", back)):
        assert torch.equal(a, b), (
            name, (a - b).abs().max().item(),
            (a != b).float().mean().item())
        log("dvo-cpu-gpu", f"FOV {name}, {len(a)} points: bit-equal")


# The JAX package's DvoTrajectory(weights="huber") on this phase's 8 frames,
# exported by the port (tools/dvo_vs_jax.py, on the CPU): aligned ATE
# 5.448e-5 m, unaligned 3.211e-4 m over a 0.2619 m extent; the port on
# the CPU read 5.444e-5 m.  The card is held within 25% of the reference,
# with a floor of 0.02 mm for a reference this small.
JAX_DVO_ATE_M = 5.448e-5
DVO_ATE_MARGIN = dict(rel=0.25, abs_m=2e-5)
N_DVO_FRAMES = 8


def phase_dvo(tum_root, device="cuda"):
    """``DvoTrajectory(weights="huber")`` with its defaults on the 8-frame
    TUM scene, read back through the TUM loader, on the card: Gauss-Newton
    iterations per frame (one host sync each), the aligned ATE and the
    unaligned ATE against the trajectory's extent.  Gated: the
    unaligned ATE < 0.05 x extent (tests/vo/test_apps.py:41), and the
    aligned ATE within DVO_ATE_MARGIN of JAX_DVO_ATE_M."""
    import tadataka_torch.vo.dvo as dvo
    from tadataka_torch.apps import DvoTrajectory
    from tadataka_torch.dataset import TumRgbdDataset
    from tadataka_torch.metrics import absolute_trajectory_error
    ds = TumRgbdDataset(tum_root, which_freiburg=1)
    frames = [ds[i] for i in range(len(ds))]
    vo = DvoTrajectory(ds.camera_model, weights="huber", device=device)
    solves = [0]
    normal_equations = dvo._normal_equations

    def counted(*args):
        solves[0] += 1
        return normal_equations(*args)

    iterations = []
    dvo._normal_equations = counted
    try:
        for frame in frames:
            vo.estimate(frame)
            iterations.append(solves[0])
            solves[0] = 0
    finally:
        dvo._normal_equations = normal_equations
    est = vo.positions()
    gt = np.stack([f.pose.t.numpy() for f in frames])
    assert np.all(np.isfinite(est))
    ate = float(absolute_trajectory_error(est, gt))
    unaligned = float(absolute_trajectory_error(est, gt, align=False))
    extent = float(np.linalg.norm(gt[-1] - gt[0]))
    log("dvo", f"{tuple(frames[0].depth_map.shape)}, {len(frames)} frames "
        "of the freiburg1 scene; Gauss-Newton iterations per frame (one "
        f"host sync each): {iterations}")
    log("dvo", f"ATE aligned {ate * 100:.5f} cm (JAX {JAX_DVO_ATE_M * 100:.5f}"
        f" cm), unaligned {unaligned * 100:.5f} cm over an extent of "
        f"{extent:.4f} m ({unaligned / extent:.2e} of it)")
    margin = max(DVO_ATE_MARGIN["rel"] * JAX_DVO_ATE_M,
                 DVO_ATE_MARGIN["abs_m"])
    assert unaligned < 0.05 * extent, (unaligned, extent)
    assert abs(ate - JAX_DVO_ATE_M) <= margin, (ate, JAX_DVO_ATE_M, margin)


# The feature phase's two configurations (bench.py's bench_euroc and
# bench_feature_vo settings, at EuRoC's and VGA size) and its gates: the
# aligned ATE as a share of the ground truth's extent under 1.25 x the
# JAX package's reading on the same frames, and the first motion's
# cosine (in the first camera's frame) over 0.95, as
# tests/vo/test_feature_based.py asks.  The JAX package's readings
# (tools/feature_vs_jax.py, on the CPU): EuRoC ATE 0.07357 of the
# extent, first-motion cos -0.06691, whole-path cos 0.28108; synthetic
# 0.01222, cos 0.99997; the port on the CPU read 0.07129-0.07710 /
# -0.05911 / 0.27989-0.28444 and 0.01159-0.01222 / 0.99997 over four
# generator seeds and the JAX draws.  On EuRoC neither package finds
# the direction (4.4 cm a frame against planes 1.9-2.9 m away, with 0.43
# degrees of rotation a frame), first motion or whole path, so EuRoC is
# gated on its aligned ATE alone and its cosine is read.
FEATURE_CONFIGS = {
    "euroc": dict(vo=dict(fast_threshold=10.0 / 255.0, min_matches=24,
                          max_keypoints=512), frames=N_EUROC_FRAMES),
    "synthetic": dict(vo=dict(fast_threshold=20.0 / 255.0, min_matches=40,
                              max_keypoints=1024), frames=8),
}
JAX_FEATURE_ATE_SHARE = {"euroc": 0.07357, "synthetic": 0.01222}
FEATURE_ATE_MARGIN = 1.25
FEATURE_COS = {"synthetic": 0.95}
# tests/vo/test_feature_based.py's configuration, on its 120x160 sequence
FEATURE_TEST_VO = dict(window_size=8, min_matches=12, max_keypoints=512,
                       patch_size=24, fast_threshold=0.02)
def feature_frames(config):
    """(frames, true positions) of a feature configuration: the EuRoC
    export's left images as float32 / 255, or the multi-plane scene at
    480x640, focal 480, on tests/vo/test_feature_based.py's trajectory,
    with the EuRoC export's high-frequency texture (the default texture
    holds no FAST corner at 20/255 at this size)."""
    from tadataka_torch.dataset import EurocDataset, export_euroc_scene
    from tadataka_torch.dataset.frame import Frame
    from tadataka_torch.dataset.synthetic import (
        MULTI_PLANES, PlaneSceneDataset, _sharp_texture)
    n = FEATURE_CONFIGS[config]["frames"]
    if config == "euroc":
        with tempfile.TemporaryDirectory() as root:
            export_euroc_scene(root, n_frames=n, image_shape=EUROC_SHAPE)
            ds = EurocDataset(root)
            lefts = [ds[i][0] for i in range(n)]
        frames = [Frame(f.camera_model, f.pose,
                        f.image.numpy().astype(np.float32) / 255.0, None)
                  for f in lefts]
    else:
        poses = trajectory(n, step=(0.25, 0.01, 0.02), yaw=0.002)
        ds = PlaneSceneDataset(n, VGA, (VGA_FOCAL, VGA_FOCAL), poses=poses,
                               planes=MULTI_PLANES, texture=_sharp_texture)
        frames = [ds[i] for i in range(n)]
    return frames, np.stack([f.pose.t.numpy() for f in frames])


def fixed_draws(site, shape):
    """RANSAC draws that do not depend on the device: the same uniform
    floats at every site and call."""
    return np.random.default_rng(3939).random(shape, dtype=np.float32)


def feature_quality(est, gt, R0):
    """(aligned ATE / extent, cosine of the first motion, cosine of the
    whole path's motion), the true motion taken into the first camera's
    frame by its rotation ``R0``."""
    from tadataka_torch.metrics import absolute_trajectory_error
    est, gt = np.asarray(est, np.float64), np.asarray(gt, np.float64)
    extent = float(np.linalg.norm(gt[-1] - gt[0]))
    share = float(absolute_trajectory_error(est, gt)) / extent

    def cos(k):
        d_est = est[k] - est[0]
        d_gt = np.asarray(R0, np.float64).T @ (gt[k] - gt[0])
        return float(d_est @ d_gt / (np.linalg.norm(d_est)
                                     * np.linalg.norm(d_gt)))
    return share, cos(1), cos(-1)


def drive_feature(frames, device, vo_args, prefetch=False, rng=None,
                  count_syncs=False):
    """One FeatureBasedVO over the frames on ``device``: (vo, poses,
    per-frame host syncs, per-frame ``frame_stats``).  With ``prefetch``
    each estimate is preceded by the next frame's extraction, as
    bench_feature_vo does; bench_euroc does not prefetch."""
    import warnings
    from tadataka_torch.vo.feature_based import FeatureBasedVO
    vo = FeatureBasedVO(device=device, rng=rng, **vo_args)
    if prefetch:
        vo.prefetch(frames[0])
    poses, syncs, stats = [], [], []
    for k, frame in enumerate(frames):
        with warnings.catch_warnings(record=True) as caught:
            if count_syncs:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
            if prefetch and k + 1 < len(frames):
                vo.prefetch(frames[k + 1])
            poses.append(vo.estimate(frame))
            if count_syncs:
                torch.cuda.set_sync_debug_mode("default")
        syncs.append(sum("synchroniz" in str(w.message) for w in caught))
        stats.append(vo.frame_stats)
    return vo, poses, syncs, stats


def feature_run_on(config, frames, gt, device="cuda"):
    """The configuration on ``device`` with its own generator, counting
    host syncs and the PnP kernel's launches; the quality gates.  Returns
    the kernel's launches."""
    from tadataka_torch.utils.timing import trace
    with trace() as tr:
        vo, poses, syncs, stats = drive_feature(
            frames, device, FEATURE_CONFIGS[config]["vo"],
            prefetch=config == "synthetic", count_syncs=device == "cuda")
    pnp_launches = pnp_kernel_launches(tr)
    assert all(p is not None for p in poses), config
    share, cos, path_cos = feature_quality([p.t.numpy() for p in poses],
                                           gt, frames[0].pose.R.numpy())
    keypoints = [st["keypoints"] for st in stats]
    matches = [sum(len(p) for p in st["matches"]) for st in stats]
    inliers = [st["pnp_inliers"] for st in stats]
    shape = tuple(np.asarray(frames[0].image).shape)
    log("feature", f"{config}: {len(frames)} frames at {shape[0]}x"
        f"{shape[1]}, {FEATURE_CONFIGS[config]['vo']}; keypoints per frame "
        f"{keypoints}, matches kept {matches}, PnP inliers {inliers}, map "
        f"points {len(vo.point_dict)}, host syncs per frame {syncs}, PnP "
        f"kernel launches {pnp_launches} (15 a Gauss-Newton)")
    ref = JAX_FEATURE_ATE_SHARE[config]
    cos_gate = (f"gate > {FEATURE_COS[config]}" if config in FEATURE_COS
                else "read, not gated")
    log("feature", f"{config}: aligned ATE {share:.5f} of the extent "
        f"(gate < {FEATURE_ATE_MARGIN} x JAX's {ref}), first-motion cos "
        f"{cos:.5f} ({cos_gate}), whole-path cos {path_cos:.5f}")
    assert share < FEATURE_ATE_MARGIN * ref, (config, share)
    assert config not in FEATURE_COS or cos > FEATURE_COS[config], (
        config, cos)
    return pnp_launches


def feature_cpu_vs_card(name, frames, vo_args, devices=("cpu", "cuda")):
    """A configuration on the CPU and twice on the card with the same
    draws: the two card runs bit-equal (no atomic sum on the path), each
    frame's extraction and each consecutive pair's matching (mutual-NN
    with the ratio test, and the guided gate) bit-equal on CPU and card,
    the Matcher's kept matches, every pose and the map bit-equal (past
    matching every factorization runs on the host and every other
    operation in a fixed order: core/solvers.py, core/rounding.py); the
    stage-by-stage comparison (``feature_stage_parting``) printed."""
    from tadataka_torch.features.matching import (
        match_descriptors, match_descriptors_guided)
    cpu, card = devices
    runs = {key: drive_feature(frames, key[0], vo_args, rng=fixed_draws)
            for key in ((cpu, 0), (card, 0), (card, 1))}
    poses = {key: run[1] for key, run in runs.items()}
    assert all(p is not None for ps in poses.values() for p in ps), name
    assert all(torch.equal(a.R, b.R) and torch.equal(a.t, b.t)
               for a, b in zip(poses[card, 0], poses[card, 1])), name
    vos = {cpu: runs[cpu, 0][0], card: runs[card, 0][0]}
    assert all(sorted(vo.features) == list(range(len(frames)))
               for vo in vos.values()), name
    for v in range(len(frames)):
        for x, y in zip(vos[cpu].features[v], vos[card].features[v]):
            assert torch.equal(x, y.cpu()), (name, v)
        assert np.array_equal(vos[cpu].raw_keypoints[v],
                              vos[card].raw_keypoints[v]), (name, v)
    matched = {}
    for d, vo in vos.items():
        feats = [vo.features[v] for v in range(len(frames))]
        pred = vos[cpu].features[0].keypoints.to(d) + 0.002
        matched[d] = []
        for f0, f1 in zip(feats, feats[1:]):
            m = match_descriptors(f0.descriptors, f1.descriptors, f0.mask,
                                  f1.mask)
            g = match_descriptors_guided(f0.descriptors, f1.descriptors,
                                         f0.mask, f1.mask, pred,
                                         f1.keypoints, 0.02)
            matched[d] += [x.cpu() for x in (m.indices, m.mask, g.indices,
                                             g.mask)]
    assert all(torch.equal(a, b)
               for a, b in zip(matched[cpu], matched[card])), name
    n_masks = n_differ = 0
    for a, b in zip(runs[cpu, 0][3], runs[card, 0][3]):
        for pa, pb in zip(a["matches"], b["matches"]):
            sa, sb = set(map(tuple, pa)), set(map(tuple, pb))
            n_masks += len(sa | sb)
            n_differ += len(sa ^ sb)
    same_poses = all(torch.equal(a.R, b.R) and torch.equal(a.t, b.t)
                     for a, b in zip(poses[cpu, 0], poses[card, 0]))
    maps = [vos[d].point_dict for d in devices]
    same_map = (sorted(maps[0]) == sorted(maps[1]) and all(
        np.array_equal(maps[0][k], maps[1][k]) for k in maps[0]))
    log("feature", f"{name} CPU against card (the same draws): two card "
        f"runs bit-equal; extraction of {len(frames)} frames and the "
        f"matching of each consecutive pair (mutual NN + ratio, guided "
        f"gate) bit-equal; the Matcher's kept matches differ in "
        f"{n_differ} of {n_masks}; poses of {len(frames)} frames "
        f"{'bit-equal' if same_poses else 'DIFFER'}, map of "
        f"{len(maps[0])} points {'bit-equal' if same_map else 'DIFFERS'}")
    parting = feature_stage_parting(name, frames, vo_args, devices)
    assert n_differ == 0 and same_poses and same_map and parting is None, (
        name, n_differ, same_poses, same_map, parting)
    return {d: poses[d, 0] for d in devices}


def first_parting(a, b):
    """The first entry of two ``utils/timing.py`` captures (lists of
    (stage, name, value)) whose bits differ: (index, stage, name, largest
    difference), or None where the captures are equal."""
    for i, ((sa, na, va), (sb, nb, vb)) in enumerate(zip(a, b)):
        if (sa, na) != (sb, nb) or va.shape != vb.shape:
            return i, f"{sa}/{sb}", f"{na}/{nb}", float("nan")
        if not np.array_equal(va, vb, equal_nan=True):
            with np.errstate(invalid="ignore"):
                diff = np.abs(va.astype(np.float64) - vb.astype(np.float64))
            return i, sa, na, float(np.nanmax(diff)) if diff.size else 0.0
    if len(a) != len(b):
        return min(len(a), len(b)), "end", "length", float("nan")
    return None


def feature_stage_parting(name, frames, vo_args, devices=("cpu", "cuda")):
    """Where the VO on the card first parts from the CPU with the same
    draws: each frame run under ``utils/timing.py``'s ``capture()``
    (RANSAC's trial scores and chosen trial, E and its decomposition,
    the cheirality vote, each triangulated map, each PnP's trials and
    argmax and its Gauss-Newton steps, each BA's normal equations and
    every LM trial's error and decision) on both devices, and the
    captures compared entry by entry.  Returns (frame, stage, quantity,
    largest difference) of the first difference, or None."""
    from tadataka_torch.utils.timing import capture
    from tadataka_torch.vo.feature_based import FeatureBasedVO
    captured = {}
    for device in devices:
        vo = FeatureBasedVO(device=device, rng=fixed_draws, **vo_args)
        captured[device] = []
        for frame in frames:
            with capture() as values:
                vo.estimate(frame)
            captured[device].append(values)
    n_values = sum(len(v) for v in captured[devices[0]])
    for k, (a, b) in enumerate(zip(*(captured[d] for d in devices))):
        parting = first_parting(a, b)
        if parting is not None:
            i, stage, quantity, diff = parting
            log("feature", f"{name}: the card first parts from the CPU at "
                f"frame {k}, stage {stage!r}, {quantity} (value {i} of the "
                f"frame's {len(a)}), largest difference {diff:.3e}")
            return k, stage, quantity, diff
    log("feature", f"{name}: every probed value of every frame bit-equal "
        f"on CPU and card ({n_values} values)")
    return None


def test_sequence_frames(n=5):
    """tests/vo/test_feature_based.py's sequence: n frames of the
    multi-plane scene at 120x160, focal 120."""
    from tadataka_torch.dataset.synthetic import multi_plane_scene
    ds = multi_plane_scene(n, (120, 160), (120.0, 120.0),
                           trajectory(n, step=(0.25, 0.01, 0.02),
                                      yaw=0.002))
    return [ds[i] for i in range(n)]


def feature_test_sequence():
    """tests/vo/test_feature_based.py's sequence and configuration (5
    frames of the multi-plane scene at 120x160, focal 120) on the CPU and
    the card: bit-equal, and that test's own gates (aligned ATE under
    0.25 of the extent, first-motion cos over 0.95)."""
    frames = test_sequence_frames()
    gt = np.stack([f.pose.t.numpy() for f in frames])
    poses = feature_cpu_vs_card("test sequence 120x160", frames,
                                FEATURE_TEST_VO)
    for device, ps in poses.items():
        share, cos, _ = feature_quality([p.t.numpy() for p in ps], gt,
                                        frames[0].pose.R.numpy())
        log("feature", f"test sequence 120x160 on {device}: aligned ATE "
            f"{share:.5f} of the extent (gate < 0.25), first-motion cos "
            f"{cos:.5f} (gate > 0.95)")
        assert share < 0.25 and cos > 0.95, (device, share, cos)


def phase_feature():
    """FeatureBasedVO on the card: EuRoC's 480x752 export with
    bench_euroc's setting and the multi-plane scene at 480x640 with
    bench_feature_vo's, each gated on quality; then EuRoC and
    the reference's 120x160 test sequence on the CPU and the card with
    the same draws.  Returns the PnP kernel's launches in the runs that
    count host syncs."""
    launches = 0
    for config in FEATURE_CONFIGS:
        frames, gt = feature_frames(config)
        launches += feature_run_on(config, frames, gt)
        if config == "euroc":
            euroc_frames = frames
    feature_cpu_vs_card("euroc", euroc_frames, FEATURE_CONFIGS["euroc"]["vo"])
    feature_test_sequence()
    return launches


# VITAMIN-E (phase vitamin_e): examples/vitamin_e_vo.py's trajectory on
# the multi-plane scene at 480x640, focal 480, 5 frames, with the JAX
# package's VitaminEVO defaults but fast_threshold=0.02 and lambda_=0.5;
# gated on the JAX package's readings of the same frames on the CPU
# (JAX_PLATFORMS=cpu python tools/vitamin_e_vs_jax.py): aligned ATE over
# the true extent under 1.25 x JAX's, the map at least 0.8 x JAX's and
# over 1000 points (tests/realdata/test_new_tsukuba_real.py's gate).
N_VITAMIN_E_FRAMES = 5
VITAMIN_E_VO = dict(fast_threshold=0.02, lambda_=0.5)
VITAMIN_E_TEXTURE = "sharp"
JAX_VITAMIN_E = dict(ate_share=0.04010, map_points=2062)


def vitamin_e_frames(texture=VITAMIN_E_TEXTURE, n=N_VITAMIN_E_FRAMES,
                     shape=VGA, focal=VGA_FOCAL):
    """(frames with float32 CPU images, true camera positions): the
    multi-plane scene on examples/vitamin_e_vo.py's trajectory (rotvec (0,
    0.003 i, 0), t (0.15 i, 0.01 i, 0)), the default texture or the
    EuRoC export's ("sharp")."""
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


def drive_vitamin_e(frames, device, rng=None, count_syncs=False):
    """One VitaminEVO over the frames on ``device``: (vo, poses, per-frame
    host syncs)."""
    import warnings
    from tadataka_torch.vo.vitamin_e import VitaminEVO
    vo = VitaminEVO(frames[0].camera_model, device=device, rng=rng,
                    **VITAMIN_E_VO)
    poses, syncs = [], []
    for frame in frames:
        with warnings.catch_warnings(record=True) as caught:
            if count_syncs:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
            poses.append(vo.estimate(frame.image))
            if count_syncs:
                torch.cuda.set_sync_debug_mode("default")
        syncs.append(sum("synchroniz" in str(w.message) for w in caught))
    return vo, poses, syncs


def vitamin_e_cpu_vs_card(frames, devices=("cpu", "cuda")):
    """The front end and the VO with the same draws on the CPU and the
    card: the curvature and its extrema of every frame, ORB's descriptors
    at every frame's FAST keypoints, every KeypointFrame of
    ``track_sequence``, and VitaminEVO's poses, keypoint frames and map
    (on the CPU and twice on the card), bit-equal."""
    from tadataka_torch.features import Matcher
    from tadataka_torch.features.brief import extract_features
    from tadataka_torch.features.curvature import (
        compute_image_curvature, extract_curvature_extrema)
    from tadataka_torch.features.orb import orb_descriptors
    from tadataka_torch.vo.vitamin_e import track_sequence
    front = {}
    for device in devices:
        images = [f.image.to(device) for f in frames]
        tensors = []
        for image in images:
            tensors.append(compute_image_curvature(image))
            tensors += list(extract_curvature_extrema(image, 98.0, 2048))
            feats = extract_features(image, 512, VITAMIN_E_VO[
                "fast_threshold"], 64)
            tensors += list(orb_descriptors(image, feats.keypoints,
                                            feats.mask))
        tracks = track_sequence(images, matcher=Matcher(rng=fixed_draws),
                                **VITAMIN_E_VO)
        front[device] = ([t.cpu() for t in tensors], tracks)
    cpu, card = devices
    assert all(torch.equal(a, b) for a, b in zip(*(front[d][0]
                                                    for d in devices)))
    assert all(np.array_equal(a.ids, b.ids)
               and np.array_equal(a.coords, b.coords)
               for a, b in zip(front[cpu][1], front[card][1]))
    runs = [drive_vitamin_e(frames, d, rng=fixed_draws)
            for d in (cpu, card, card)]

    def same(a, b):
        vo_a, poses_a = a[:2]
        vo_b, poses_b = b[:2]
        return (all(torch.equal(p.R, q.R) and torch.equal(p.t, q.t)
                    for p, q in zip(poses_a, poses_b))
                and all(np.array_equal(x.ids, y.ids)
                        and np.array_equal(x.coords, y.coords)
                        for x, y in zip(vo_a.keypoints, vo_b.keypoints))
                and sorted(vo_a.points) == sorted(vo_b.points)
                and all(np.array_equal(vo_a.points[k], vo_b.points[k])
                        for k in vo_a.points))
    cards_equal, cpu_equal = same(runs[1], runs[2]), same(runs[0], runs[1])
    log("vitamin_e", f"CPU against card (the same draws): the curvature, "
        f"its extrema and ORB's descriptors of {len(frames)} frames and "
        f"every KeypointFrame of track_sequence "
        f"({[len(k.ids) for k in front[cpu][1]]} tracks) bit-equal; "
        f"VitaminEVO's poses, keypoint frames and map of "
        f"{len(runs[0][0].points)} points: two card runs "
        f"{'bit-equal' if cards_equal else 'DIFFER'}, CPU and card "
        f"{'bit-equal' if cpu_equal else 'DIFFER'}")
    assert cards_equal and cpu_equal


def phase_vitamin_e():
    """VitaminEVO at 480x640 on the card: the CPU-card comparison, then a
    run with the card's own generator gated on the JAX readings, its host
    syncs and the PnP kernel's launches counted.  Returns the kernel's
    launches."""
    from tadataka_torch.metrics import absolute_trajectory_error
    from tadataka_torch.utils.timing import trace
    frames, gt = vitamin_e_frames()
    vitamin_e_cpu_vs_card(frames)
    with trace() as tr:
        vo, poses, syncs = drive_vitamin_e(frames, "cuda", count_syncs=True)
    pnp_launches = pnp_kernel_launches(tr)
    assert all(p is not None for p in poses), poses
    est = np.stack([p.t.numpy() for p in poses]).astype(np.float64)
    extent = float(np.linalg.norm(gt[-1] - gt[0]))
    share = float(absolute_trajectory_error(est, gt.astype(np.float64))
                  ) / extent
    log("vitamin_e", f"{len(frames)} frames at {VGA[0]}x{VGA[1]}, focal "
        f"{VGA_FOCAL}, {VITAMIN_E_TEXTURE} texture, {VITAMIN_E_VO}; tracks "
        f"per frame {[len(k.ids) for k in vo.keypoints]}, map points "
        f"{len(vo.points)}, host syncs per frame {syncs}, PnP kernel "
        f"launches by frame {tr.counts['pnp.normal_kernel']}")
    ref = JAX_VITAMIN_E
    log("vitamin_e", f"aligned ATE {share:.5f} of the true extent (gate < "
        f"{FEATURE_ATE_MARGIN} x JAX's {ref['ate_share']}), map "
        f"{len(vo.points)} points (gates >= 0.8 x JAX's "
        f"{ref['map_points']}, > 1000)")
    assert share < FEATURE_ATE_MARGIN * ref["ate_share"], share
    assert len(vo.points) >= 0.8 * ref["map_points"]
    assert len(vo.points) > 1000
    return pnp_launches


# ------------------------------------------------------- the parallel phase

def event_turns(fns, rounds=5):
    """Median ms of each callable, timed by CUDA events in turns (one
    call of each a round, after one warm-up round)."""
    times = {name: [] for name in fns}
    for r in range(rounds + 1):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            fn()
            end.record()
            end.synchronize()
            if r:
                times[name].append(start.elapsed_time(end))
    return {name: statistics.median(t) for name, t in times.items()}


def recorded_update(device):
    """The slice's last update as the app makes it (``update`` in
    apps/semi_dense_vo.py): (keyframe, stacked refframes, clamped ages,
    prior depth, prior variance, params) on ``device``, and its plan."""
    from tadataka_torch.parallel.mesh import to_device
    from tadataka_torch.vo.semi_dense import make_frame, stack_frames
    rec = UPDATE_INPUTS["slice"]
    keyframe = make_frame(rec["cam"], rec["image"], rec["T_wk"])
    refs = stack_frames(rec["refs"])
    age = torch.clamp(rec["age"], 0, refs.image.shape[0])
    return to_device((keyframe, refs, age, rec["depth"], rec["variance"],
                      rec["params"]), device), rec["plan"]


def all_equal(a, b):
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


def parallel_sweep(smi):
    """Phase 5's last update (a steady `tent` frame, 8 refframes)
    column-sharded over PARALLEL_SHARDS shards of the card: one
    ssd_search launch a shard, each shard's search checked against the
    plain version; the maps torch.equal to the one-device update +
    regularize on the card and to the same sharded call on the CPU; then
    the row-sharded scattered update torch.equal to the one-device one
    and to the CPU's.
    Returns the main path's ssd_search launches."""
    from tadataka_torch.parallel import (
        make_mesh, make_sharded_update_sweep, sharded_update_depth)
    from tadataka_torch.parallel.mesh import unshard
    from tadataka_torch.vo.semi_dense import regularize, update_depth
    from tadataka_torch.vo.semi_dense.fast import update_depth_fast
    from tadataka_torch.vo.semi_dense.sweep import ring_config, ssd_search
    n = PARALLEL_SHARDS
    card, plan = recorded_update("cuda")
    host, _ = recorded_update("cpu")
    H, W = card[3].shape
    assert plan.path == "tent", plan
    mesh = make_mesh(["cuda:0"] * n)
    sweep = make_sharded_update_sweep(mesh, (H, W), plan)

    ssd_search.launches = 0
    out = sweep(*card)
    torch.cuda.synchronize()
    launches = ssd_search.launches
    assert launches == n, (launches, n)
    out = [unshard(mesh, b, 1) for b in out]

    def single():
        d, v, f = update_depth_fast(*card, plan=plan)
        return regularize(d, v, f), v, f

    assert all_equal(out, single()), "sharded sweep != one-device update"
    cpu_mesh = make_mesh(["cpu"] * n)
    t0 = time.perf_counter()
    cpu = [unshard(cpu_mesh, b, 1) for b in make_sharded_update_sweep(
        cpu_mesh, (H, W), plan)(*host)]
    cpu_s = time.perf_counter() - t0
    assert all_equal(out, cpu), "sharded sweep: card != CPU"

    with SearchCapture() as capture:
        sweep(*card)
    assert len(capture.calls) == n, len(capture.calls)
    for i, args in enumerate(capture.calls):
        assert tuple(args[0].shape[1:]) == (H, W // n), args[0].shape
        assert all(x.is_contiguous() for x in args)
        check_search(f"shard {i}'s search", args)
    S = capture.calls[0][0].shape[0]
    ring = ring_config(S, H, W // n)
    timing = time_search("parallel", f"shard 0's search of {n}",
                         capture.calls[0])
    ms = event_turns({"sharded": lambda: sweep(*card), "single": single})
    success = (out[2] == 0).float().mean().item()
    log("parallel", f"column-sharded sweep, {n} shards of {H}x{W // n} on "
        f"one card, plan {plan.n_planes}: {launches} ssd_search launches "
        f"(S={S}, ring plan {ring['ring']}: grid {ring['grid']}), every "
        "shard's search bit-equal to plain; depth, "
        "variance and flags torch.equal to update_depth_fast + regularize "
        f"on the card and to the sharded call on the CPU ({cpu_s:.1f} s); "
        f"SUCCESS share {success:.3f}; ms per update (CUDA events, in "
        f"turns, medians of 5): sharded {ms['sharded']:.2f}, one device "
        f"{ms['single']:.2f} ({smi})")

    rows = [unshard(mesh, b) for b in sharded_update_depth(mesh, *card)]
    assert all_equal(rows, update_depth(*card)), "row-sharded != one-device"
    t0 = time.perf_counter()
    cpu = [unshard(cpu_mesh, b) for b in sharded_update_depth(cpu_mesh,
                                                              *host)]
    cpu_s = time.perf_counter() - t0
    assert all_equal(rows, cpu), "row-sharded update: card != CPU"
    log("parallel", f"row-sharded scattered update, {n} shards of "
        f"{H // n}x{W}: torch.equal to update_depth on the card and to the "
        f"sharded call on the CPU ({cpu_s:.1f} s)")
    return launches, timing


def ba_scene(seed, n_viewpoints, n_points, obs_per_point=None):
    """The JAX package's BA test scenes (tests/parallel/test_parallel.py):
    every viewpoint sees every point (``obs_per_point`` None, the
    64-point scene), or ``obs_per_point`` observations of each point from
    random viewpoints (the realistic scale).  Returns (noisy poses, noisy
    points, viewpoint indices, point indices, x_true), made on the host."""
    from tadataka_torch.ba.residuals import transform_project
    rng = np.random.default_rng(seed)
    spread, depth, turn = ((1, 5.0, 0.1) if obs_per_point is None
                           else (2, 8.0, 0.05))
    points = rng.uniform(-spread, spread, (n_points, 3)).astype(np.float32)
    points[:, 2] += depth
    rotvecs = rng.uniform(-turn, turn, (n_viewpoints, 3)).astype(np.float32)
    ts = rng.uniform(-0.5, 0.5, (n_viewpoints, 3)).astype(np.float32)
    poses = np.hstack([rotvecs, ts])
    if obs_per_point is None:
        vi, pi_ = (g.T.ravel() for g in np.meshgrid(np.arange(n_viewpoints),
                                                     np.arange(n_points)))
    else:
        pi_ = np.repeat(np.arange(n_points), obs_per_point)
        vi = rng.integers(0, n_viewpoints, pi_.shape[0])
    x_true = transform_project(torch.from_numpy(poses)[vi],
                               torch.from_numpy(points)[pi_]).numpy()
    poses_noisy = (poses + rng.normal(0, 0.01, poses.shape)).astype(
        np.float32)
    points_noisy = (points + rng.normal(0, 0.05, points.shape)).astype(
        np.float32)
    return poses_noisy, points_noisy, vi, pi_, x_true


def reprojection_mse(poses, points, vi, pi_, x_true):
    from tadataka_torch.ba.residuals import projection_residuals
    r = projection_residuals(poses.cpu(), points.cpu(), torch.as_tensor(vi),
                             torch.as_tensor(pi_), torch.from_numpy(x_true))
    return float(torch.mean(torch.sum(r * r, dim=-1)))


def parallel_ba(smi):
    """Landmark-sharded BA at the JAX package's realistic scale
    (PARALLEL_BA: 10,240 landmarks, 8 viewpoints, 3 observations each)
    over PARALLEL_SHARDS shards of the card, max_iter=15: the JAX test's
    gate (mean squared reprojection error < 1e-8), two card runs and a
    CPU run bit-equal; ms per LM iteration, host syncs per iteration and
    the solve's peak device memory (above what earlier phases hold)."""
    import warnings
    import tadataka_torch.parallel.distributed_ba as dba
    from tadataka_torch.parallel import distributed_lm_solve, make_mesh
    scene = ba_scene(3939, **PARALLEL_BA)
    n = PARALLEL_SHARDS
    mesh = make_mesh(["cuda:0"] * n)
    assemble = dba._local_assemble
    calls = [0]

    def counted(*args):
        calls[0] += 1
        return assemble(*args)

    dba._local_assemble = counted
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()    # earlier phases' tensors
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            first = distributed_lm_solve(mesh, *scene, max_iter=15)
            torch.cuda.set_sync_debug_mode("default")
        peak = (torch.cuda.max_memory_allocated() - held) / 2**20
        iterations = calls[0] // n
    finally:
        dba._local_assemble = assemble
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    second = distributed_lm_solve(mesh, *scene, max_iter=15)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    cpu = distributed_lm_solve(make_mesh(["cpu"] * n), *scene, max_iter=15)
    mse = reprojection_mse(first[0], first[1], *scene[2:])
    log("parallel", f"landmark-sharded BA, {PARALLEL_BA}, {n} shards on the "
        f"card: {iterations} LM iterations, {ms / iterations:.2f} ms an "
        f"iteration ({ms:.1f} ms in all), host syncs an iteration "
        f"{syncs / iterations:.1f} ({syncs} in all), peak device memory "
        f"{peak:.1f} MiB above what was held before; reprojection MSE {mse:.3e} (gate < 1e-8), error "
        f"{float(first[2]):.3e}; two card runs "
        f"{'bit-equal' if all_equal(first, second) else 'DIFFER'}, CPU and "
        f"card {'bit-equal' if all_equal(first, cpu) else 'DIFFER'} ({smi})")
    assert mse < 1e-8, mse
    assert bool(torch.isfinite(first[1]).all())
    assert all_equal(first, second) and all_equal(first, cpu)


def ba_worker(rank, port, outdir):
    """One of the two processes of parallel_two_processes: joins the gloo
    group, runs the BA over PARALLEL_SHARDS shards of the card (the mesh
    spans both processes) and saves its result."""
    sys.path.insert(0, str(ROOT))
    from tadataka_torch.parallel import distributed_lm_solve, make_mesh
    from tadataka_torch.parallel.multihost import initialize_distributed
    rank = int(rank)
    assert initialize_distributed(f"127.0.0.1:{port}", 2, rank) == (rank, 2)
    assert torch.distributed.get_backend() == "gloo"
    mesh = make_mesh(["cuda:0"] * PARALLEL_SHARDS)
    assert mesh.size == 2 * PARALLEL_SHARDS and mesh.spans_processes
    scene = np.load(Path(outdir) / "scene.npz")
    poses, points, err = distributed_lm_solve(
        mesh, *(scene[k] for k in ("poses", "points", "vi", "pi", "x")),
        max_iter=30)
    np.savez(Path(outdir) / f"out_{rank}.npz", poses=poses.cpu().numpy(),
             points=points.cpu().numpy(), err=float(err))
    torch.distributed.destroy_process_group()


def parallel_two_processes(smi):
    """The JAX two-process test's scene (seed 7, 4 viewpoints, 64 points)
    over 2 x PARALLEL_SHARDS shards in two processes that share the card,
    joined by initialize_distributed with gloo (NCCL refuses two ranks on
    one GPU): both return the same poses and points, converged (error <
    1e-6); compared with one process's run over the same 8 shards."""
    import socket
    from tadataka_torch.parallel import distributed_lm_solve, make_mesh
    scene = ba_scene(7, 4, 64)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as outdir:
        np.savez(Path(outdir) / "scene.npz", **dict(zip(
            ("poses", "points", "vi", "pi", "x"), scene)))
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--ba-worker",
             str(rank), str(port), outdir],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for rank in range(2)]
        try:
            outs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, o in zip(procs, outs):
            assert p.returncode == 0, o[-4000:]
        seconds = time.perf_counter() - t0
        results = [np.load(Path(outdir) / f"out_{r}.npz") for r in range(2)]
        results = [{k: r[k] for k in r.files} for r in results]
    for k in ("poses", "points", "err"):
        assert np.array_equal(results[0][k], results[1][k]), k
    err = float(results[0]["err"])
    assert err < 1e-6, err
    one = distributed_lm_solve(make_mesh(["cuda:0"] * 2 * PARALLEL_SHARDS),
                               *scene, max_iter=30)
    one = [one[0].cpu().numpy(), one[1].cpu().numpy()]
    same = all(np.array_equal(a, results[0][k])
               for a, k in zip(one, ("poses", "points")))
    diff = max(float(np.max(np.abs(a - results[0][k])))
               for a, k in zip(one, ("poses", "points")))
    log("parallel", f"two processes on the one card (gloo), "
        f"{2 * PARALLEL_SHARDS} shards, the 64-point scene: both processes "
        f"equal, error {err:.3e} (< 1e-6), {seconds:.1f} s with start-up; "
        "against one process's 8-shard run: "
        + ("bit-equal" if same else f"largest difference {diff:.3g} (the "
           "cross-process sum adds the processes' partial sums)")
        + f" ({smi})")


def phase_parallel(smi):
    """The parallel paths at full width on the card: the column-sharded
    sweep and the row-sharded update on phase 5's last frame, the
    landmark-sharded BA at 10,240 landmarks, and the BA in two processes
    sharing the card.  Returns (ssd_search launches, the shard search's
    timing)."""
    launches, timing = parallel_sweep(smi)
    parallel_ba(smi)
    parallel_two_processes(smi)
    return launches, timing


# ------------------------------------------------------------ the long phase

# tests/vo/test_long_trajectory.py's sequence: 30 frames of the
# multi-plane scene, at that test's 80x100 (focal 80) for the CPU-card
# comparison and at 480x640 (focal 480) for the full-width drive
N_LONG_FRAMES = 30
LONG_CHECK = dict(shape=(80, 100), focal=80.0)
# that test's FeatureBasedVO and map-upkeep settings
LONG_FEATURE_VO = dict(fast_threshold=6.0 / 255.0, min_matches=16,
                       max_keypoints=768)
LONG_MAP = dict(history=4, default_depth=8.0, default_variance=1.0,
                uncertainty_bias=0.01, noise=(0.93, 1.07), seed=5,
                variance=0.05)


def long_poses(n=N_LONG_FRAMES):
    """tests/vo/test_long_trajectory.py's camera->world poses: a
    sideways sweep, forward drift and a yaw / pitch wobble."""
    from tadataka_torch.core.pose import Pose
    f32 = torch.float32
    return [Pose.from_rotvec(
        torch.tensor([0.002 * np.sin(0.4 * i), 0.004 * i, 0.001 * i],
                     dtype=f32),
        torch.tensor([0.12 * i + 0.03 * np.sin(0.5 * i),
                      0.02 * np.cos(0.3 * i), 0.02 * i], dtype=f32))
        for i in range(n)]


def long_sequence(shape=LONG_CHECK["shape"], focal=LONG_CHECK["focal"],
                  n=N_LONG_FRAMES, texture=None):
    """The long sequence's frames at ``shape``, rendered on the CPU, with
    the default texture or ``texture``."""
    from tadataka_torch.dataset.synthetic import (
        MULTI_PLANES, PlaneSceneDataset, default_texture)
    ds = PlaneSceneDataset(n, shape, (focal, focal), poses=long_poses(n),
                           planes=MULTI_PLANES,
                           texture=texture or default_texture)
    return [ds[i] for i in range(n)]


def long_dvo_vo(frames, device):
    """The long test's DvoTrajectory (Huber weights, 4 levels, 15
    iterations a level) for the frames' camera."""
    from tadataka_torch.apps import DvoTrajectory
    return DvoTrajectory(frames[0].camera_model, weights="huber",
                         n_coarse_to_fine=4, max_iter=15, device=device)


def long_dvo(frames, device):
    """Frame-chained DVO on exact depth over the frames: the estimated
    positions, (n, 3) float32 on the host, and the poses."""
    vo = long_dvo_vo(frames, device)
    for frame in frames:
        vo.estimate(frame)
    return vo.positions(), vo.trajectory


def long_map(frames, device, on_frame=None):
    """The long test's map upkeep driven with the true poses: propagate
    + increment_age (the plain reference of the JAX test's
    propagate_tent), the planned update over a history of 4, regularize.
    ``on_frame(i, depth, variance, flags, plan)`` runs after frame i's
    update.  Returns (median |depth - GT| after frames 3 and n-1, the
    last flags)."""
    from tadataka_torch.camera import CameraParameters
    from tadataka_torch.vo.semi_dense import (
        SemiDenseParams, increment_age, make_frame, propagate, regularize,
        stack_frames)
    from tadataka_torch.vo.semi_dense.fast import (
        plan_update_np, update_depth_fast)
    c = LONG_MAP
    H, W = frames[0].image.shape
    focal = frames[0].camera_model.camera_parameters.focal_length.tolist()
    cam = CameraParameters.create(focal, (W / 2.0, H / 2.0), device=device)
    params = SemiDenseParams.create(2.0, 50.0, ref_step_size=0.002,
                                    min_gradient=0.01, device=device)
    q0, q1 = 1.0 / 50.0, 1.0 / 2.0
    focal_np = np.array(focal, np.float64)
    offset_np = np.array([W / 2.0, H / 2.0], np.float64)
    gt0 = frames[0].depth_map.numpy()
    noise = np.random.default_rng(c["seed"]).uniform(*c["noise"], gt0.shape)
    depth = torch.from_numpy((gt0 * noise).astype(np.float32)).to(device)
    variance = torch.full((H, W), c["variance"], device=device)
    age = torch.zeros((H, W), dtype=torch.int32, device=device)

    def frame_of(f):
        return make_frame(cam, f.image.to(device), f.pose.T.to(device))

    history = [frames[0]]
    errors = {}
    for i in range(1, len(frames)):
        f = frames[i]
        T10 = (f.pose.inv() * history[-1].pose).T.to(device)
        age = increment_age(age, cam, cam, T10, depth)
        depth, variance = propagate(T10, cam, cam, depth, variance,
                                    c["default_depth"], c["default_variance"],
                                    c["uncertainty_bias"])
        history = history[-c["history"]:]
        n = len(history)
        plan = plan_update_np(
            f.pose.T.double().numpy(), focal_np, offset_np, (H, W),
            np.stack([h.pose.T.double().numpy() for h in history]),
            np.broadcast_to(focal_np, (n, 2)),
            np.broadcast_to(offset_np, (n, 2)), q0, q1)
        depth, variance, flags = update_depth_fast(
            frame_of(f), stack_frames([frame_of(h) for h in history]),
            torch.clamp(age, 0, n), depth, variance, params, plan=plan,
            fuse_prior=True)
        depth = regularize(depth, variance, flags)
        history.append(f)
        if on_frame is not None:
            on_frame(i, depth, variance, flags, plan)
        if i in (3, len(frames) - 1):
            errors[i] = float(np.median(np.abs(
                depth.cpu().numpy() - f.depth_map.numpy())))
    return errors[3], errors[len(frames) - 1], flags


def long_feature(frames, device, rng=None, vo_args=LONG_FEATURE_VO):
    """FeatureBasedVO over the frames: (vo, the pose of each frame, None
    where it lost track)."""
    from tadataka_torch.vo.feature_based import FeatureBasedVO
    vo = FeatureBasedVO(device=device, rng=rng, **vo_args)
    return vo, [vo.estimate(frame) for frame in frames]


# The JAX package's readings on the long phase's full-width inputs
# (JAX_PLATFORMS=cpu python tools/long_vs_jax.py): SemiDenseVO over 30
# frames of phase 5's trajectory at 1/4 and 1/2 size, last frame: SUCCESS
# share 0.0874-0.1154, median |depth - GT| on SUCCESS 1.6066-1.6185,
# cos(t_est, t_gt) 0.5944-0.6088, gated as phase 5 is (half the least
# share, 1.25 x the largest error, the least cosine less 0.1); the
# pipelined app's flushed last frame 0.0979-0.1157, 1.0144-1.4757 and
# 0.4653-0.5731, gated likewise; DvoTrajectory at 480x640: unaligned ATE
# 0.005800 of the extent, RPE 0.001905; FeatureBasedVO at 480x640: 30 of
# 30 frames posed, aligned ATE 0.002280 of the extent.  The card is held
# to 1.25 x JAX's DVO and feature-VO readings, as the dvo and feature
# phases are.
LONG_SLICE_GATES = dict(success=0.5 * 0.0874, err=1.25 * 1.6185,
                        cos=0.5944 - 0.1)
LONG_PIPELINED_GATES = dict(success=0.5 * 0.0979, err=1.25 * 1.4757,
                            cos=0.4653 - 0.1)
JAX_LONG = dict(dvo_ate_share=0.005800, dvo_rpe=0.001905,
                feature_ate_share=0.002280)
LONG_MARGIN = 1.25
# device memory of the semi-dense apps, whose state has a fixed size:
# memory_allocated after frame 29 within this of its value after frame 10
LONG_MEMORY_SLACK = 1 << 20


def frame_loop(frames, step, read=lambda out: out):
    """``step(frame)`` over the frames on the card; after each frame,
    memory_allocated is read and then ``read(output)``.  Only the last
    output is kept, so the loop holds no frame's tensors: (the last
    output, per-frame ``read`` results, per-frame memory_allocated)."""
    reads, memory = [], []
    out = None
    for frame in frames:
        del out
        out = step(frame)
        memory.append(torch.cuda.memory_allocated())
        reads.append(read(out))
    return out, reads, memory


def memory_growth(name, memory):
    """Prints memory_allocated after frames 10 and 29 of a drive;
    returns its change."""
    grown = memory[29] - memory[10]
    log("long", f"{name}: memory_allocated after frame 10 {memory[10]} B, "
        f"after frame 29 {memory[29]} B ({grown:+d} B)")
    return grown


def all_finite(*tensors):
    return all(bool(torch.isfinite(x).all()) for x in tensors
               if x is not None)


def finite_state(state):
    """No NaN or Inf in a semi-dense state's maps and pose."""
    return all_finite(state.depth_map, state.variance_map, state.flag_map,
                      state.pose_wc.R, state.pose_wc.t)


def long_cpu_vs_card(devices=("cpu", "cuda")):
    """(a) The long test's sequence at 80x100 on the CPU and the card:
    DVO's poses, the map upkeep's depth, variance and flags after every
    frame (seven cycles of the size-4 history) and the feature VO's poses
    and map (the same draws; the BA window's evictions) bit for bit.
    Returns the ssd_search launches of the card's map upkeep."""
    from tadataka_torch.vo.semi_dense.sweep import ssd_search
    frames = long_sequence()
    dvo, maps, feature = {}, {}, {}
    for device in devices:
        dvo[device] = long_dvo(frames, device)[1]
        maps[device] = []
        ssd_search.launches = 0
        long_map(frames, device, on_frame=lambda i, *m: maps[device].append(
            [x.cpu() for x in m[:3]]))
        launches = ssd_search.launches
        vo, poses = long_feature(frames, device, rng=fixed_draws)
        feature[device] = (poses, vo.point_dict)
    cpu, card = devices
    assert all(torch.equal(a.R, b.R.cpu()) and torch.equal(a.t, b.t.cpu())
               for a, b in zip(dvo[cpu], dvo[card])), "DVO poses differ"
    for i, (a, b) in enumerate(zip(maps[cpu], maps[card]), start=1):
        assert all(torch.equal(x, y) for x, y in zip(a, b)), (
            f"the map after frame {i} differs")
    (poses_c, map_c), (poses_g, map_g) = feature[cpu], feature[card]
    assert [p is None for p in poses_c] == [p is None for p in poses_g]
    assert all(a is None or (torch.equal(a.R, b.R.cpu())
                             and torch.equal(a.t, b.t.cpu()))
               for a, b in zip(poses_c, poses_g)), "feature VO poses differ"
    assert sorted(map_c) == sorted(map_g) and all(
        np.array_equal(map_c[k], map_g[k]) for k in map_c), "maps differ"
    log("long", f"(a) {LONG_CHECK['shape'][0]}x{LONG_CHECK['shape'][1]}, "
        f"{len(frames)} frames: DVO's poses, the map upkeep's depth, "
        f"variance and flags after each of {len(maps[cpu])} updates "
        f"({launches} ssd_search launches on the card), the feature VO's "
        f"{sum(p is not None for p in poses_g)} poses and map of "
        f"{len(map_g)} points bit-equal on the CPU and the card")
    return launches


def long_semi_dense():
    """(b) SemiDenseVO and PipelinedSemiDenseVO over 30 frames of phase
    5's scene and settings at 480x640, each with ssd_search's count at 0
    before and read after: finite states, the JAX readings' gates on the
    last frame (the pipelined app's flushed one), memory_allocated after
    frame 29 within LONG_MEMORY_SLACK of its value after frame 10.
    Returns the launches."""
    from collections import Counter
    from tadataka_torch.dataset import multi_plane_scene
    from tadataka_torch.vo.semi_dense.sweep import ssd_search
    n = N_LONG_FRAMES
    ds = multi_plane_scene(n, VGA, (VGA_FOCAL, VGA_FOCAL), trajectory(n))
    frames = [ds[i] for i in range(n)]
    bootstrap = frames[1].pose.inv() * frames[0].pose
    total = 0

    vo = make_vo(VGA, VGA_FOCAL, "cuda", metrics=PlanLog())
    vo.initial_pose_fn = lambda image0, image1: bootstrap
    ssd_search.launches = 0
    last, finite, memory = frame_loop(frames, vo.estimate, finite_state)
    total += ssd_search.launches
    assert all(finite), finite
    plans = Counter(f"{p['plan_path']}/{p['plan_n_planes']}"
                    for _, p in vo.metrics.frames)
    quality = depth_and_pose_quality(last, frames[-1])
    log("long", f"(b) SemiDenseVO, 480x640, {n} frames: plans "
        + ", ".join(f"{k} x{v}" for k, v in plans.items())
        + f"; the plan cache holds {len(vo._plan_cache)} plans (one a "
        "new rounded pose, kept for the VO's life, as in the JAX app); "
        f"ssd_search launches {ssd_search.launches}; last frame: "
        f"SUCCESS share {quality[0]:.4f}, median |depth - GT| "
        f"{quality[1]:.4f}, cos(t_est, t_gt) {quality[2]:.4f} (gates "
        f"{LONG_SLICE_GATES})")
    grown = memory_growth("SemiDenseVO", memory)
    check_gates(quality, LONG_SLICE_GATES)
    assert abs(grown) <= LONG_MEMORY_SLACK, grown

    pvo = make_pipelined(VGA, VGA_FOCAL, "cuda", metrics=PlanLog())
    pvo.initial_pose_fn = lambda image0, image1: bootstrap
    ssd_search.launches = 0
    _, finite, memory = frame_loop(frames, pvo.estimate, finite_state)
    last = pvo.flush_map()
    total += ssd_search.launches
    assert all(finite) and finite_state(last), finite
    quality = depth_and_pose_quality(last, frames[-1])
    plans = Counter(p["plan_path"] for _, p in pvo.metrics.frames)
    log("long", f"(b) PipelinedSemiDenseVO, 480x640, {n} frames + flush: "
        f"plans {dict(plans)}; ssd_search launches "
        f"{ssd_search.launches}; flushed last frame: SUCCESS share "
        f"{quality[0]:.4f}, median |depth - GT| {quality[1]:.4f}, "
        f"cos(t_est, t_gt) {quality[2]:.4f} (gates {LONG_PIPELINED_GATES})")
    grown = memory_growth("PipelinedSemiDenseVO", memory)
    check_gates(quality, LONG_PIPELINED_GATES)
    assert abs(grown) <= LONG_MEMORY_SLACK, grown
    return total


def long_dvo_and_feature():
    """(b) DvoTrajectory and FeatureBasedVO (its own generator) over the
    long test's 30 poses at 480x640, focal 480 (the feature VO on the
    EuRoC export's texture, as the feature phase): finite poses and map,
    the JAX readings' gates; memory printed, not gated (their maps and
    trajectories grow)."""
    from tadataka_torch.dataset.synthetic import _sharp_texture
    from tadataka_torch.metrics import (
        absolute_trajectory_error, relative_pose_error)
    from tadataka_torch.vo.feature_based import FeatureBasedVO
    frames = long_sequence(VGA, VGA_FOCAL)
    gt = np.stack([f.pose.t.numpy() for f in frames]).astype(np.float64)
    extent = float(np.linalg.norm(gt[-1] - gt[0]))
    vo = long_dvo_vo(frames, "cuda")
    _, finite, memory = frame_loop(frames, vo.estimate,
                                   lambda p: all_finite(p.R, p.t))
    assert all(finite), finite
    est = vo.positions().astype(np.float64)
    share = float(absolute_trajectory_error(est, gt, align=False)) / extent
    rpe = float(relative_pose_error(est, gt, delta=1))
    log("long", f"(b) DvoTrajectory, 480x640, {len(frames)} frames: "
        f"unaligned ATE {share:.6f} of the extent {extent:.4f} (gate < "
        f"{LONG_MARGIN} x JAX's {JAX_LONG['dvo_ate_share']}), RPE {rpe:.6f} "
        f"(gate < {LONG_MARGIN} x JAX's {JAX_LONG['dvo_rpe']})")
    memory_growth("DvoTrajectory", memory)
    assert share < LONG_MARGIN * JAX_LONG["dvo_ate_share"], share
    assert rpe < LONG_MARGIN * JAX_LONG["dvo_rpe"], rpe

    frames = long_sequence(VGA, VGA_FOCAL, texture=_sharp_texture)
    vo = FeatureBasedVO(device="cuda", **LONG_FEATURE_VO)
    _, poses, memory = frame_loop(
        frames, vo.estimate,
        lambda p: None if p is None else (p.R.cpu(), p.t.cpu()))
    posed = [k for k, p in enumerate(poses) if p is not None]
    assert all(all_finite(*poses[k]) for k in posed)
    assert all(np.isfinite(x).all() for x in vo.point_dict.values())
    est = np.stack([poses[k][1].numpy() for k in posed]).astype(np.float64)
    kept = gt[posed]
    share = float(absolute_trajectory_error(est, kept)) / float(
        np.linalg.norm(kept[-1] - kept[0]))
    log("long", f"(b) FeatureBasedVO, 480x640, {LONG_FEATURE_VO}: "
        f"{len(posed)} of {len(frames)} frames posed (gate >= "
        f"{len(frames) - 2}), aligned ATE {share:.6f} of the extent (gate < "
        f"{LONG_MARGIN} x JAX's {JAX_LONG['feature_ate_share']}), map "
        f"{len(vo.point_dict)} points")
    memory_growth("FeatureBasedVO", memory)
    assert len(posed) >= len(frames) - 2, posed
    assert share < LONG_MARGIN * JAX_LONG["feature_ate_share"], share


def phase_long():
    """The long phase: tests/vo/test_long_trajectory.py's horizon on the
    card.  (a) its 80x100 sequence on the CPU and the card, bit for bit;
    (b) 30 frames at 480x640 through SemiDenseVO, PipelinedSemiDenseVO,
    DvoTrajectory and FeatureBasedVO, gated on the JAX package's
    readings, device memory read.  Returns the ssd_search launches of its
    main-path drives."""
    launches = long_cpu_vs_card()
    launches += long_semi_dense()
    long_dvo_and_feature()
    log("long", f"phase passed; ssd_search launches {launches}")
    return launches


def main():
    if sys.argv[1:2] == ["--ba-worker"]:
        ba_worker(*sys.argv[2:5])
        return
    smi = phase_environment()
    sys.path.insert(0, str(ROOT))
    t0 = time.perf_counter()
    phase_build()
    timings = phase_kernel_vs_plain()
    probe_entries, floor_gbs = phase_probes()
    gather_entries = phase_gather(floor_gbs)
    phase_cpu_vs_gpu()
    launches, tent_searches = phase_slice()
    rect_launches, rect_searches = phase_rect()
    launches += rect_launches
    phase_captured({"tent": tent_searches, "rect": rect_searches})
    del tent_searches, rect_searches
    phase_scatter()
    phase_app_gate()
    phase_stereo(smi)
    phase_euroc(smi)
    launches += phase_pipelined()
    from tadataka_torch.dataset import export_tum_scene
    with tempfile.TemporaryDirectory() as tum_root:
        t_export = time.perf_counter()
        export_tum_scene(tum_root, n_frames=N_DVO_FRAMES, which_freiburg=1,
                         image_shape=VGA)
        log("dvo", f"exported {N_DVO_FRAMES} freiburg1 frames at 480x640 in "
            f"{time.perf_counter() - t_export:.1f} s")
        phase_dvo_cpu_gpu(tum_root)
        phase_dvo(tum_root)
    pnp_launches = phase_feature()
    pnp_launches += phase_vitamin_e()
    parallel_launches, _ = phase_parallel(smi)
    launches += parallel_launches
    launches += phase_long()
    at48 = timings[("random", 48, 480, 640)]
    pnp = timings["pnp_normal"]
    log("done", f"all phases passed in {time.perf_counter() - t0:.1f} s; "
        "ms/plain_ms below: ssd_search (the ring kernel) at S=48, the SSD "
        "probes at S=32, the gather probes on their scripts' inputs, "
        "480x640, pnp_normal at B=1, n=2000; launches: the slice, rect, "
        "pipelined, parallel and long phases (ssd_search), the "
        "probe runs (the probes), the feature and vitamin_e phases' "
        "sync-counting drives (pnp_normal); bound_ms "
        "at the data sheet's 3.35 TB/s and 67 TFLOP/s, ssd_search's at "
        "what its inputs need")
    print(smi)
    print(json.dumps({"kernels": [kernel_entry(
        "ssd_search", SSD_SOURCE, SSD_REPLACES, launches, 0.0,
        at48["ms"], at48["plain_ms"], at48["n_bytes"],
        at48["flops"])] + probe_entries + gather_entries + [kernel_entry(
            "pnp_normal", PNP_SOURCE, PNP_REPLACES, pnp_launches, 0.0,
            pnp["ms"], pnp["plain_ms"], pnp["n_bytes"], pnp["flops"])]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
