"""Host-side planner + dispatcher of the semi-dense depth update
(counterpart of ``tadataka_tpu/vo/semi_dense/fast.py``).

The planner is kept exactly, because its plane counts, redirects and
choice of path change the results: it picks, from the 4x4 poses alone,

  tent    — the homography plane sweep (sweep.py) with per-refframe
            plane counts; refframes whose warp exceeds the displacement
            cap are redirected to the nearest feasible one;
  rect    — the rectified disparity sweep, for wide lateral baselines
            (planned here; its sweep is not in the reference);
  scatter — the scattered per-pixel estimator.

In the port the budget constants (``TENT_BUDGET_MAX``, ``RECT_MAX_DX``,
the buckets) only pick the plan; they size no warp, since the port's
warps are gathers.
"""

from typing import NamedTuple

import numpy as np

from bench_port.reference.port.vo.semi_dense.params import N_KEY_SAMPLES
from bench_port.reference.port.vo.semi_dense.rectify import (
    rectification_feasible, _np_homography_displacement)

RECT_MAX_DX = 32
RECT_MAX_DY = 32
TENT_BUDGET_MAX = 32   # per-plane displacement cap of the tent plan
MAX_PLANES = 256
_BUDGET_BUCKETS = (4, 8, 12, 16, 24, 32, 48)


class UpdatePlan(NamedTuple):
    path: str            # 'rect' | 'tent' | 'scatter'
    n_planes: tuple      # per-refframe for tent; (n,) global for rect
    flips: tuple         # rect only
    warp_budget: tuple   # tent only, per-refframe
    redirect: tuple      # tent only: age index -> swept refframe index


def _bucket_budget(v):
    for b in _BUDGET_BUCKETS:
        if v <= b:
            return b
    return None


def _bucket_planes(v, cap=MAX_PLANES):
    n = int(np.ceil(max(v, 8) / 16.0)) * 16
    return min(n, cap)


def _np_K(f, c):
    return np.array([[f[0], 0, c[0]], [0, f[1], c[1]], [0, 0, 1.0]])


def _plane_H(T_rk, q, key_f, key_c, ref_f, ref_c):
    R, t = T_rk[:3, :3], T_rk[:3, 3]
    A = R + q * np.outer(t, [0.0, 0.0, 1.0])
    return _np_K(ref_f, ref_c) @ A @ np.linalg.inv(_np_K(key_f, key_c))


def _np_homography_span(Ha, Hb, image_shape, n=9):
    """Max |Ha x - Hb x| over a coarse grid: the longest epipolar track
    between two planes."""
    Hh, Ww = image_shape
    X, Y = np.meshgrid(np.linspace(0, Ww - 1.0, n), np.linspace(0, Hh - 1.0, n))
    P = np.stack([X.ravel(), Y.ravel(), np.ones(X.size)])
    Qa = Ha @ P
    Qb = Hb @ P
    if np.any(Qa[2] <= 1e-9) or np.any(Qb[2] <= 1e-9):
        return np.inf
    return float(np.hypot(Qa[0] / Qa[2] - Qb[0] / Qb[2],
                          Qa[1] / Qa[2] - Qb[1] / Qb[2]).max())


def plan_update(keyframe, refframes, params) -> UpdatePlan:
    """Choose the update path from device frames (reads the poses to the
    host; the VO app calls :func:`plan_update_np` on host poses instead)."""
    def host(x):
        return x.detach().cpu().numpy().astype(np.float64)
    return plan_update_np(
        host(keyframe.transform_wf), host(keyframe.focal_length),
        host(keyframe.offset), tuple(keyframe.image.shape),
        host(refframes.transform_wf), host(refframes.focal_length),
        host(refframes.offset), float(params.min_inv_depth),
        float(params.max_inv_depth))


def plan_update_np(key_T, key_f, key_c, image_shape,
                   R_T, ref_fs, ref_cs, q0, q1) -> UpdatePlan:
    """Pure-numpy planner core: no device arrays, no syncs.  ``key_T`` may
    be a predicted keyframe pose."""
    n_refs = R_T.shape[0]

    # --- rect feasibility + disparity range ---
    rect_ok = True
    flips = []
    rect_range_px = 8.0
    for r in range(n_refs):
        T_rk = np.linalg.inv(R_T[r]) @ key_T
        # rect needs a real baseline
        if np.linalg.norm(T_rk[:3, 3]) < 1e-5:
            rect_ok = False
            break
        ok, flip = rectification_feasible(
            T_rk, key_f, key_c, ref_fs[r], ref_cs[r], image_shape,
            RECT_MAX_DX, RECT_MAX_DY)
        if not ok:
            rect_ok = False
            break
        flips.append(flip)
        Rr, tr = T_rk[:3, :3], T_rk[:3, 3]
        b = -Rr.T @ tr
        B = np.linalg.norm(b)
        fB = key_f[0] * B
        # per-pixel v_z spread over the image corners: coverage must span
        # [min_vz * q0, max_vz * q1] disparities
        sgn = -1.0 if flip else 1.0
        r1 = sgn * b / B
        r2 = np.cross([0.0, 0.0, 1.0], r1)
        r2 = r2 / max(np.linalg.norm(r2), 1e-12)
        r3 = np.cross(r1, r2)
        Hh, Ww = image_shape
        cx = (np.array([0.0, Ww - 1.0]) - key_c[0]) / key_f[0]
        cy = (np.array([0.0, Hh - 1.0]) - key_c[1]) / key_f[1]
        vz = np.array([r1[2] * x + r2[2] * y + r3[2]
                       for x in cx for y in cy])
        span = fB * (vz.max() * q1 - vz.min() * q0)
        rect_range_px = max(rect_range_px, span)
    rect_plan = None
    if rect_ok and rect_range_px + N_KEY_SAMPLES + 4 <= MAX_PLANES:
        rect_plan = UpdatePlan(
            'rect',
            (_bucket_planes(rect_range_px + N_KEY_SAMPLES + 4),),
            tuple(flips), (), ())

    # --- tent sweep feasibility, PER refframe ---
    q_mid = 0.5 * (q0 + q1)
    budgets = []   # per-refframe (far-half, near-half) bucketed budgets
    planes = []
    for r in range(n_refs):
        T_rk = np.linalg.inv(R_T[r]) @ key_T
        d_by_q = {}
        Hs = {}
        feasible = True
        for q in (q0, q_mid, q1):
            H_q = _plane_H(T_rk, q, key_f, key_c, ref_fs[r], ref_cs[r])
            dx, dy = _np_homography_displacement(H_q, image_shape)
            if not np.isfinite(dx) or not np.isfinite(dy):
                feasible = False
                break
            d_by_q[q] = max(dx, dy)
            Hs[q] = H_q
        span = 8.0
        if feasible:
            span = _np_homography_span(Hs[q0], Hs[q1], image_shape)
            feasible = np.isfinite(span)
        if feasible:
            b_far = _bucket_budget(max(d_by_q[q0], d_by_q[q_mid]) + 1.0)
            b_near = _bucket_budget(max(d_by_q.values()) + 1.0)
        else:
            b_far = b_near = None
        if b_near is None or b_near > TENT_BUDGET_MAX:
            budgets.append(None)
            planes.append(0)
        else:
            budgets.append((b_far, b_near))
            # ~1-px plane spacing along this refframe's epipolar track,
            # plus the 2*half_w template-window grid extension
            planes.append(_bucket_planes(max(span, 8.0) + 10, cap=128))

    feasible_idx = [r for r in range(n_refs) if budgets[r] is not None]
    tent_plan = None
    if feasible_idx:
        redirect = tuple(
            r if budgets[r] is not None
            else min(feasible_idx, key=lambda j: (abs(j - r), j))
            for r in range(n_refs))
        tent_plan = UpdatePlan(
            'tent',
            tuple(planes[redirect[r]] for r in range(n_refs)),
            (),
            tuple(budgets[redirect[r]] or 0 for r in range(n_refs)),
            redirect)

    # preference: full-coverage tent > rect > tent with redirects >
    # scatter, except that rect wins decisively expensive tent histories
    full_tent = tent_plan is not None and len(feasible_idx) == n_refs
    if full_tent and rect_plan is not None:
        tent_cost = sum(
            s * (b[0] + b[1] + 1) / 2.0
            for s, b in zip(tent_plan.n_planes,
                            (budgets[redirect[r]] for r in range(n_refs))))
        rect_cost = (n_refs * 4 * (2 * RECT_MAX_DX + 1)
                     + 6 * rect_plan.n_planes[0])
        if tent_cost > max(3.0 * rect_cost, 3000.0):
            return rect_plan
    if full_tent:
        return tent_plan
    if rect_plan is not None:
        return rect_plan
    if tent_plan is not None:
        return tent_plan
    return UpdatePlan('scatter', (), (), (), ())


def update_depth_fast(keyframe, refframes, age_map, prior_depth,
                      prior_variance, params, plan=None, fuse_prior=False):
    """Planned semi-dense depth update: the homography sweep for a 'tent'
    plan, the scattered estimator for 'scatter' ('rect' raises).
    Returns (depth_map, variance_map, flag_map)."""
    from bench_port.reference.port.vo.semi_dense.estimator import update_depth
    from bench_port.reference.port.vo.semi_dense.sweep import update_depth_sweep

    if plan is None:
        plan = plan_update(keyframe, refframes, params)
    if plan.path == 'rect':
        # no cell's traffic plans the rectified sweep: the cell that
        # brings such traffic brings its frozen copy too
        raise NotImplementedError("the reference has no rectified sweep")
    if plan.path == 'tent':
        return update_depth_sweep(
            keyframe, refframes, age_map, prior_depth, prior_variance,
            params, n_planes=plan.n_planes, redirect=plan.redirect,
            fuse_prior=fuse_prior)
    return update_depth(keyframe, refframes, age_map, prior_depth,
                        prior_variance, params, fuse_prior=fuse_prior)
