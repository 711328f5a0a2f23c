"""The plain reference of a SemiDenseVO frame, and the check of the
frames a run sampled.

The app is a chain: each frame's tracking reads the previous frame's
maps, and its update reads the history of refframe poses.  A run
hundreds of frames long cannot be followed from scratch by a second
implementation whose last bits differ, so the reference follows the
program step by step from the program's own state: for each sampled
frame it takes the previous state (pose, depth, variance, age), the
refframes' poses and the plan the program made, works the images out
again from the host frames, and recomputes every stage from those
inputs: the tracked pose, the propagated maps, the updated maps after
the SSD search, and the regularized depth.  The start is checked on its
own: the initial map from the seed, the bootstrap frame and the first
tracked frame of every run.

The stages are frozen copies of ``tadataka_torch/apps/semi_dense_vo.py``
on the frozen port (``reference/port``); the SSD search runs its plain
version."""

import numpy as np
import torch

from bench_port.reference.common import (
    Gaps, bf16, frame_points, host_T, map_gap, pose_gap_mm, rgb2gray)
from bench_port.reference.port.camera import CameraModel, CameraParameters
from bench_port.reference.port.core.rounding import as_divisor
from bench_port.reference.port.core.transforms import motion_matrix
from bench_port.reference.port.vo.dvo import estimate_pose_pyramid
from bench_port.reference.port.vo.semi_dense.age import increment_age
from bench_port.reference.port.vo.semi_dense.estimator import (
    safe_invert, update_depth)
from bench_port.reference.port.vo.semi_dense.fast import (
    plan_update_np, update_depth_fast)
from bench_port.reference.port.vo.semi_dense.frame import (
    SemiDenseFrame, make_frame, stack_frames)
from bench_port.reference.port.vo.semi_dense.params import (
    DEFAULT_N_REF_SAMPLES, SemiDenseParams)
from bench_port.reference.port.vo.semi_dense.propagation import propagate
from bench_port.reference.port.vo.semi_dense.regularization import regularize


def gray(image_rgb_u8, device):
    """The frame as the app prepares it: luma, quantized to uint8, then
    float32 in [0, 1] on the device."""
    u8 = np.clip(np.round(rgb2gray(image_rgb_u8) * 255.0), 0, 255).astype(
        np.uint8)
    image = torch.from_numpy(u8).to(device).to(torch.float32)
    return image / as_divisor(255.0, image)


def track(camera_model, I0, D0, V0, I1, n_levels):
    eye = torch.eye(3, dtype=torch.float32, device=I0.device)
    zero = torch.zeros(3, dtype=torch.float32, device=I0.device)
    R10, t10 = estimate_pose_pyramid(
        camera_model, camera_model, I0, D0, I1, safe_invert(V0), eye, zero,
        n_levels, 20, 1.5, "map", "ic")
    return motion_matrix(R10, t10)


def propagate_step(cam, T10, D0, V0, age0, default_depth, default_variance,
                   uncertainty_bias):
    age1 = increment_age(age0, cam, cam, T10, D0)
    d1, v1 = propagate(T10, cam, cam, D0, V0, default_depth,
                       default_variance, uncertainty_bias)
    return d1, v1, age1


def update(cam, params, image, T_wk, ref_frames, age1, d1, v1, plan,
           fuse_prior, n_ref_samples):
    """The depth update without the regularization: (depth, variance,
    flags) after the SSD search."""
    keyframe = make_frame(cam, image, T_wk)
    refs = stack_frames(ref_frames)
    age_c = torch.clamp(age1, 0, refs.image.shape[0])
    if plan is None:
        return update_depth(keyframe, refs, age_c, d1, v1, params,
                            n_ref_samples=n_ref_samples,
                            fuse_prior=fuse_prior)
    return update_depth_fast(keyframe, refs, age_c, d1, v1, params,
                             plan=plan, fuse_prior=fuse_prior)


PLAN_KEY_DECIMALS = 3    # the app's memo of plans: rounded relative poses


def plan_key(key_T, ref_Ts):
    rels = np.stack([np.linalg.inv(T) @ key_T for T in ref_Ts])
    return (len(ref_Ts),
            tuple(np.round(rels[:, :3, :].ravel(), PLAN_KEY_DECIMALS)))


class Planner:
    """The plans the program may have made for a frame, from the host
    poses it planned from (``plan_inputs``: frame -> (predicted
    keyframe pose, refframe poses)), over ``history_size`` refframes."""

    def __init__(self, setting, plan_inputs, history_size):
        self.s = setting
        self.inputs = plan_inputs
        self.history = history_size
        self.first = {}          # memo key -> first frame planned with it
        for k in sorted(f for f in plan_inputs if f is not None):
            self.first.setdefault(self.key(k), k)

    def refs(self, k):
        return self.inputs[k][1][-min(k, self.history):]

    def key(self, k):
        return plan_key(self.inputs[k][0], self.refs(k))

    def plan(self, k):
        s, (key_T, _), refs = self.s, self.inputs[k], self.refs(k)
        n = len(refs)
        f = np.broadcast_to(s.focal, (n, 2))
        c = np.broadcast_to(s.offset, (n, 2))
        return plan_update_np(key_T, s.focal, s.offset, s.shape, refs, f, c,
                              s.q0, s.q1)

    def judge(self, k, program_plan, n_program_refs):
        """(the reference's plan, whether the program's plan and
        refframes are those the configuration asks for)."""
        n = min(k, self.history)
        if k not in self.inputs:
            return None, False
        mine = self.plan(k)
        memo = self.plan(self.first[self.key(k)])
        ok = (len(self.inputs[k][1]) == n and n_program_refs == n
              and program_plan is not None
              and tuple(program_plan) in (tuple(mine), tuple(memo)))
        return (program_plan if ok else mine), ok


class Setting:
    """The configuration's camera, parameters and app arguments as the
    reference's objects."""

    def __init__(self, config, device):
        c, p = config["camera"], config["params"]
        self.cam = CameraParameters.create((c["fx"], c["fy"]),
                                           (c["cx"], c["cy"]), device=device)
        self.model = CameraModel.create(self.cam)
        self.params = SemiDenseParams.create(
            p["min_depth"], p["max_depth"], ref_step_size=p["ref_step_size"],
            min_gradient=p["min_gradient"], device=device)
        self.args = config["app_args"]
        self.points = frame_points(config)
        # the planner's intrinsics: the float32 camera's, in float64
        self.focal = self.cam.focal_length.cpu().numpy().astype(np.float64)
        self.offset = self.cam.offset.cpu().numpy().astype(np.float64)
        self.shape = tuple(config["image_shape"])
        self.q0 = float(self.params.min_inv_depth)
        self.q1 = float(self.params.max_inv_depth)
        # the app's defaults where the configuration names none
        self.regularize = self.args.get("regularize_depth", True)
        self.fuse_prior = self.args.get("fuse_prior", True)
        self.n_ref_samples = self.args.get("n_ref_samples",
                                           DEFAULT_N_REF_SAMPLES)
        self.planned = self.args.get("depth_update", "fast") == "fast"


def check(captures, plan_inputs, loop, config, seed, device, err=None,
          control=False):
    """{"pose_gap_mm": ..., "map_gap_pct": ..., "plan_gap": ...} of the
    sampled frames: the program's outputs against the reference's, or
    with ``control`` the reference held in bfloat16 against the
    reference.  ``plan_gap`` counts the sampled frames whose plan or
    refframes are not the reference's."""
    s = Setting(config, device)
    a = s.args
    planner = Planner(s, plan_inputs, a["history_size"])
    plan_gaps = []
    q = bf16 if control else (lambda x: x)
    grays = {}

    def gray_of(k):
        i = loop.index(k)
        if i not in grays:
            grays[i] = gray(loop.frames[i].image, device)
        return grays[i]

    gaps = Gaps()
    for k in sorted(captures):
        c = captures[k]
        if "out" not in c:
            continue
        out = c["out"]
        if k == 0:
            H, W = config["image_shape"]
            rng = np.random.default_rng(seed)
            depth = torch.from_numpy(rng.uniform(
                *a["depth_range"], (H, W)).astype(np.float32)).to(device)
            judged = q(depth) if control else out.depth_map
            gaps.add_map("initial depth", map_gap(judged, depth))
            gaps.add_pose(k, 0.0 if control else pose_gap_mm(
                host_T(out.pose_wc.R, out.pose_wc.t), np.eye(4), s.points))
            continue
        prev = c["prev"]
        image = gray_of(k)
        # the pose: tracked from the previous state, or at the bootstrap
        # the true relative pose the run handed over
        T_prev = host_T(prev.pose_wc.R, prev.pose_wc.t)
        if "track" in c:
            t_args = c["track"][0]
            D0, V0 = t_args[2], t_args[3]
            T10 = track(s.model, gray_of(k - 1), D0, V0, image,
                        a["n_coarse_to_fine"])
            T_ref = T_prev @ np.linalg.inv(host_T(T10[:3, :3], T10[:3, 3]))
            if control:
                T10c = track(s.model, q(gray_of(k - 1)), q(D0), q(V0),
                             q(image), a["n_coarse_to_fine"])
                T_judged = T_prev @ np.linalg.inv(
                    host_T(T10c[:3, :3], T10c[:3, 3]))
            else:
                T_judged = host_T(out.pose_wc.R, out.pose_wc.t)
            gaps.add_pose(k, pose_gap_mm(T_judged, T_ref, s.points))
        # propagation from the program's pose change and previous maps
        p_args, _, p_out = c["propagate"]
        _, T10_prog, D0, V0, age0 = p_args[:5]
        ref = propagate_step(s.cam, T10_prog, D0, V0, age0,
                             a["default_depth"], a["default_variance"],
                             a["uncertainty_bias"])
        judged = ([q(x) for x in propagate_step(
            s.cam, T10_prog, q(D0), q(V0), age0, a["default_depth"],
            a["default_variance"], a["uncertainty_bias"])]
            if control else p_out)
        for name, x, r in zip(("depth", "variance", "age"), judged, ref):
            gaps.add_map("propagated " + name, map_gap(x, r))
        # the update from the program's propagated maps and pose, with
        # the reference's plan and refframe count
        u_args, _, u_out = c["update"]
        _, _, prog_image, T_wk, prog_refs, age1, d1, v1, prog_plan = \
            u_args[:9]
        if s.planned:
            plan, ok = planner.judge(k, prog_plan, len(prog_refs))
        else:
            plan, ok = None, prog_plan is None
        if not ok:
            plan_gaps.append(k)
        n = min(len(prog_refs), k, a["history_size"])
        ref_grays = [gray_of(k - n + j) for j in range(n)]
        refs = [SemiDenseFrame(s.cam.focal_length, s.cam.offset, g,
                               r.transform_wf)
                for g, r in zip(ref_grays, prog_refs[-n:])]
        if not control:
            gaps.add_map("image", map_gap(prog_image, image))
            for r, g in zip(prog_refs[-n:], ref_grays):
                gaps.add_map("refframe images", map_gap(r.image, g))
        ref = update(s.cam, s.params, image, T_wk, refs, age1, d1, v1, plan,
                     s.fuse_prior, s.n_ref_samples)
        ref_state = (regularize(*ref) if s.regularize else ref[0],
                     ref[1], ref[2])
        if control:
            refs_q = [SemiDenseFrame(r.focal_length, r.offset, q(r.image),
                                     r.transform_wf) for r in refs]
            judged = [q(x) for x in update(
                s.cam, s.params, q(image), T_wk, refs_q, age1, q(d1), q(v1),
                plan, s.fuse_prior, s.n_ref_samples)]
            state = (q(regularize(*judged)) if s.regularize else judged[0],
                     judged[1], judged[2])
        else:
            # the maps before the regularization, where it ran
            judged = c["regularize"][0][:3] if "regularize" in c else u_out
            state = (out.depth_map, out.variance_map, out.flag_map)
        for name, x, r in zip(("depth", "variance", "flags"), judged, ref):
            gaps.add_map("updated " + name, map_gap(x, r))
        for name, x, r in zip(("depth", "variance", "flags"), state,
                              ref_state):
            gaps.add_map("state " + name, map_gap(x, r))
    pose, maps = gaps.numbers(err, "control: " if control else "")
    if err is not None:
        print(f"[bench_port] {'control: ' if control else ''}frames whose "
              f"plan or refframes are not the reference's: {plan_gaps}",
              file=err, flush=True)
    return {"pose_gap_mm": pose, "map_gap_pct": maps,
            "plan_gap": float(len(plan_gaps))}
