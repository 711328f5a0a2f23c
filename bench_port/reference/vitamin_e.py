"""The plain reference of a VitaminEVO frame, and the check of the
frames a run sampled.

The app is a chain, so the reference follows it from its state: each
sampled frame is recomputed from the program's state before it (its
last keypoint frame, the previous frame's FAST/BRIEF features, the
first observations, the map and the poses they name: the snapshot),
from the same host frame and from the same random draws (a generator on
the program's device set to the snapshot's state, drawn at the same
sites in the same shapes: the matcher's 128 x 8, then the bootstrap's
256 x 8 or PnP's 128 x 5).

Three steps of a frame turn float32's last bits into different
results: the affine flow (an IRLS fit whose normal equations in pixel
coordinates are ill-conditioned; a tenth of a pixel moves the rounding
of many tracks' starts, since the climb's subpixel offsets pile up at
its half-pixel clip), the RANSACs' choices (EPnP from 5 points of a
noisy monocular map is ill-conditioned, so a trial's inlier count moves
by a few points), and the DLT's null vector at small parallax (the
point moves along its rays).  So the reference computes each of these
itself and compares it, and then carries on from the program's, which
it reads from the port's probes (``capture()``: ``flow``, ``RANSAC
pose_change``, ``essential``, ``RANSAC pnp``), stage by stage:

- frame 0: the curvature's extrema, ids from 0;
- the flow: features of the frame, matching against the program's
  previous features, the fundamental-matrix RANSAC, the homography
  filter and the IRLS fit;
- the tracks, from the program's flow: the hill climb of the previous
  tracks, those that leave the image dropped, the new area's extrema
  with ids after the last track's.  Two of its decisions read the flow
  applied to a point, which the program and the reference round in
  another order: the rounding of a climb's start to its pixel and the
  new area's test of a back-projection against the image's border.
  Where that point lies within ``TIE_PX`` of the decision (a start at a
  half pixel, a back-projection at the border), the tie is float32's
  to settle, not the method's: the reference climbs from either
  rounding and tests either side of the border, and takes the outcome
  the judged side took (``settle``);
- the pose, from the program's tracks: the RANSAC's trials on the same
  draws (the bootstrap on frame 1, tracks shared with frame 0 by id;
  PnP later, EPnP on the samples of the tracks the map holds, in the
  tracks' order, solved in float64 on the CPU), the program's own PnP
  hypotheses counted to check its choice, the inliers of the program's
  winning model by the reference's own test, and the refinement from
  the program's choice and inliers (the refit on the bootstrap's; the
  Gauss-Newton from PnP's winning hypothesis);
- the map, from the program's tracks and pose: every track whose first
  observation lies ``min_track_gap`` frames back or more and that is
  new to the map or whose gap grew, triangulated against its first
  observation, written where it lies in front of both cameras.

Each stage is ``plain_features.py`` or ``plain_geometry.py``: plain
PyTorch in float32 (EPnP in float64), independent of the port's files;
the camera's ``normalize`` is the frozen copy under ``reference/port/``.
Departures from the JAX package: none in what is computed; sums,
factorizations and the Jacobian round differently (the Gauss-Newton
Jacobian is analytic, the JAX package's automatic), and EPnP runs in
float64 on the CPU, since on 5 points of this map a float32 EPnP parts
from a float64 one by a median of 0.3-10 px over a trial's points in
every implementation (the JAX package's, the port's and this one's
alike; more where cuSOLVER factors on the card), while fitting the
points as well (``tools/vitamin_e_epnp_witness.py``).

The numbers the check returns, each the largest over the sampled
frames:

- ``pose_gap_px``: the largest distance, in pixels, between the
  projections of the frame's points under the program's pose and under
  the reference's (PnP's inliers; on frame 1 the points it
  triangulated).  The monocular map has no metric scale, and this
  number has none either.
- ``track_gap_pct``: the share, in %, of the frame's tracks (the union
  of both sides' ids) whose id is missing on one side or whose
  coordinates differ by more than 1e-3 px, ties settled as above.
  Tracks that have climbed onto the same extremum keep their own ids,
  so one start at a tie may count for several of them.
- ``map_gap_pct``: the share, in %, of the points (re)triangulated in the
  frame (the union of both sides' ids) that one side wrote and the
  other did not.
- ``map_gap_px``: the 99th percentile over the points both sides wrote
  of the distance, in pixels, between a point's projections, the larger
  of its two views.
- ``flow_gap_px``: the largest distance, in pixels, between the
  previous tracks moved by the program's flow and by the reference's.
- ``ransac_gap_pct``: in % of the RANSAC's points, on frame 1 the
  difference between the program's winning trial's inliers and the
  reference's best trial's on the same draws; on PnP frames how far
  the program's winning trial falls short of its best trial, both
  counted by the reference on the program's hypotheses; 100 where the
  draws differ (the generator's state after the frame).
- ``inlier_gap_pct``: the share, in %, of the RANSAC's points on which
  the program's inliers of its winning model (those of the refit on
  frame 1, of the refinement after) and the reference's differ.
- ``epnp_fit_px``: the median over PnP's trials of how much worse, in
  pixels, the program's EPnP hypothesis fits the trial's 5 points than
  the reference's float64 solution (their mean reprojection distances;
  the hypotheses themselves part by pixels wherever float32 does, see
  above).

The control holds the image, the coordinates, the flow and the points
that each stage reads in bfloat16 (``common.bf16``), and is judged
against the reference."""

import numpy as np
import torch

from bench_port.harness.traffic import camera_model
from bench_port.reference import plain_features as pf
from bench_port.reference import plain_geometry as pg
from bench_port.reference.common import bf16, rgb2gray

TRACK_TOL_PX = 1e-3
# a point of the flow this close to a decision (a half pixel, the border)
# is a tie: the check does not tell coordinates this close apart
TIE_PX = TRACK_TOL_PX
NEW_AREA_PERCENTILE = 98.0     # the tracker's new area, as the JAX package's
NEW_AREA_KEYPOINTS = 2048
NUMBERS = ("pose_gap_px", "track_gap_pct", "map_gap_pct", "map_gap_px",
           "flow_gap_px", "ransac_gap_pct", "inlier_gap_pct", "epnp_fit_px")


def _same(x):
    return x


def init_tracks(image, args):
    kps, valid = pf.extrema(pf.curvature(image), args["percentile"],
                            args["max_track_keypoints"])
    coords = kps[valid].cpu().numpy()
    return np.arange(len(coords), dtype=np.int64), coords


def flow(prev, image, args, draws, q):
    """The affine flow (3, 3) from the previous frame to this one:
    features of the frame, matches against the program's previous
    features, the RANSAC and homography filters, the IRLS fit."""
    feats = pf.features(image, args["fast_threshold"],
                        args["max_keypoints"], args["patch_size"])
    p0, p1 = pf.matched_pairs(tuple(q(x) for x in prev.features), feats,
                              draws)
    return pf.irls_affine(q(p0), q(p1), q=q)


def tie_starts(start):
    """Each climb's start (K, 2) as (K, 4, 2): itself, then with x, with
    y and with both rounded to the other pixel where the start lies
    within ``TIE_PX`` of a half pixel on that axis (itself elsewhere)."""
    low = torch.floor(start)
    tie = ((start - low) - 0.5).abs() <= TIE_PX
    other = torch.where(torch.round(start) == low, low + 1.0, low)
    alt = torch.where(tie, other, start)
    return torch.stack([start, torch.stack([alt[:, 0], start[:, 1]], -1),
                        torch.stack([start[:, 0], alt[:, 1]], -1), alt], 1)


def within(xy, shape, margin):
    H, W = shape
    return ((xy[..., 0] >= -margin) & (xy[..., 0] <= W - 1 + margin)
            & (xy[..., 1] >= -margin) & (xy[..., 1] <= H - 1 + margin))


def settled_climbs(moved, ids, shape, settle):
    """Which of each track's climbs (K, 4, 2) to take: the first, or,
    where they part at a tie and ``settle`` (the judged side's ids and
    coords) is given, the one nearest the judged side's track of that
    id, or one that leaves the image where that side dropped it."""
    pick = np.zeros(len(moved), np.int64)
    parted = (moved != moved[:, :1]).any(-1).any(-1).cpu().numpy()
    if settle is None or not parted.any():
        return pick
    judged = dict(zip(settle[0].tolist(), settle[1]))
    for i in np.flatnonzero(parted):
        xy = judged.get(int(ids[i]))
        if xy is None:
            off = (~pf.in_image(moved[i], shape)).cpu().numpy()
            pick[i] = int(np.argmax(off))
        else:
            gap = moved[i].cpu().double().numpy() - np.asarray(xy,
                                                                np.float64)
            pick[i] = int(np.argmin(np.hypot(gap[:, 0], gap[:, 1])))
    return pick


def track(prev, image, M, args, settle=None):
    """The frame's tracks (ids, coords): the previous tracks moved by
    the affine flow ``M`` and corrected by the hill climb, those that
    leave the image dropped, and the new area's extrema (those whose
    back-projection leaves the image) appended with ids after the last
    track's.  ``settle``, the judged side's (ids, coords), settles the
    ties (``TIE_PX``) of a start's rounding and of the border test."""
    device = image.device
    curv = pf.curvature(image)
    coords0 = torch.as_tensor(prev.coords, device=device)
    starts = tie_starts(pf.apply_affine(M, coords0))
    moved = pf.climb(curv, starts.reshape(-1, 2), args["lambda_"]
                     ).reshape(starts.shape)
    pick = settled_climbs(moved, prev.ids, image.shape, settle)
    moved = moved[torch.arange(len(moved), device=device),
                  torch.as_tensor(pick, device=device)]
    kept = pf.in_image(moved, image.shape)
    kps, valid = pf.extrema(curv, NEW_AREA_PERCENTILE, NEW_AREA_KEYPOINTS)
    back = pf.apply_affine(torch.linalg.inv(M), kps)
    spawn = valid & ~pf.in_image(back, image.shape)
    first = int(prev.ids[-1]) + 1 if len(prev.ids) else 0
    tie = valid & (within(back, image.shape, TIE_PX)
                   != within(back, image.shape, -TIE_PX))
    if settle is not None and bool(tie.any()):
        ids_s, xy_s = settle
        spawned = {tuple(xy) for xy in np.asarray(
            xy_s, np.float32)[np.asarray(ids_s) >= first].tolist()}
        for j in torch.nonzero(tie).flatten().tolist():
            spawn[j] = tuple(kps[j].tolist()) in spawned
    new = kps[spawn]
    kept_np = kept.cpu().numpy()
    ids = np.concatenate([prev.ids[kept_np],
                          np.arange(first, first + len(new), dtype=np.int64)])
    coords = np.concatenate([moved[kept].cpu().numpy(),
                             new.cpu().numpy()]).astype(np.float32)
    return ids, coords


def _normalize(cm, coords, device, q):
    return q(cm.normalize(q(torch.as_tensor(np.asarray(coords, np.float32),
                                            device=device))))


def _probe(out, stage, name, device, dtype=None):
    """A value the program probed on the frame, as a tensor on
    ``device``; None where the port did not probe it."""
    value = (out.probes or {}).get(f"{stage}/{name}")
    if value is None:
        return None
    value = torch.as_tensor(np.asarray(value), device=device)
    return value if dtype is None else value.to(dtype)


def program_choice(out, frame, device):
    """The program's RANSAC choice on a frame, from its probes: on frame
    1 the essential RANSAC's winning model (``F``, normalized
    coordinates), its inliers (``count``) and the refit's inliers
    (``mask``); after, PnP's hypotheses (``Rs``, ``ts``), the winner
    (``best``) and the refinement's inliers (``mask``).  None where a
    probe is missing."""
    if frame == 1:
        models = _probe(out, "RANSAC pose_change", "models", device)
        best = _probe(out, "RANSAC pose_change", "best", device)
        counts = _probe(out, "RANSAC pose_change", "trial_inliers", device)
        mask = _probe(out, "essential", "inliers", device, torch.bool)
        if any(v is None for v in (models, best, counts, mask)):
            return None
        return {"F": models[int(best)], "count": int(counts[int(best)]),
                "mask": mask}
    values = {name: _probe(out, "RANSAC pnp", name, device)
              for name in ("Rs", "ts", "best", "inliers")}
    if any(v is None for v in values.values()):
        return None
    return {"Rs": values["Rs"], "ts": values["ts"],
            "best": int(values["best"]), "mask": values["inliers"].bool()}


def pose(prev, ids, coords, cm, args, draws, choice, device, q):
    """The frame's pose from the program's tracks: the RANSAC's trials on
    the draws, the inliers of the program's winning model by the
    reference's arithmetic (``mask``), and the refinement from the
    program's choice (the refit on the bootstrap's inliers; the
    Gauss-Newton from PnP's winning hypothesis on its inliers).  A dict:
    ``pose`` (world -> camera (3, 4)), ``mask``; on frame 1 ``count``
    (the most inliers of a trial); on PnP frames ``hyp`` (each trial's
    EPnP (R, t), solved in float64 on the CPU), ``winner`` (the first
    trial with the most inliers), ``samples`` (each trial's points and
    keypoints), ``inputs`` (PnP's points and keypoints) and ``points``
    (the refinement's inliers); None where the frame has too few
    tracks."""
    if prev.frame == 1:
        _, i0, i1 = np.intersect1d(prev.ids, ids, return_indices=True)
        if len(i0) < 8:
            return None
        if len(choice["mask"]) != len(i0):
            return None       # the program's bootstrap took other tracks
        x0 = _normalize(cm, prev.coords[i0], device, q)
        x1 = _normalize(cm, coords[i1], device, q)
        counts = pg.essential_trials(x0, x1, draws)
        mask = torch.sqrt(pf.sampson(q(choice["F"]), x0, x1)) < 0.002
        R, t = pg.bootstrap_refit(x0, x1, choice["mask"])
        out = {"count": int(counts.max()), "mask": mask}
    else:
        mapped = dict(zip(prev.map_ids.tolist(), range(len(prev.map_ids))))
        sel = [i for i, tid in enumerate(ids.tolist()) if tid in mapped]
        if len(sel) < 6 or len(choice["mask"]) != len(sel):
            return None       # too few tracks, or PnP took other ones
        points = q(torch.as_tensor(
            prev.map_points[[mapped[ids[i]] for i in sel]], device=device))
        x = _normalize(cm, coords[sel], device, q)
        samples = pf.sample_indices(draws, torch.ones(
            len(x), dtype=torch.bool, device=device))
        Rs, ts = pg.epnp(points[samples].cpu().double(),
                         x[samples].cpu().double())
        counts = pg.trial_counts(Rs.to(device, torch.float32),
                                 ts.to(device, torch.float32), points, x,
                                 args["pnp_threshold"])
        best = choice["best"]
        R0, t0 = (q(choice[k][best]) for k in ("Rs", "ts"))
        mask = pg.reprojection_errors(R0, t0, points, x) < args[
            "pnp_threshold"]
        weights = choice["mask"].to(points.dtype)
        R, t = pg.gauss_newton(R0, t0, points, x, weights)
        out = {"hyp": (Rs, ts), "winner": int(counts.argmax()),
               "samples": (points[samples], x[samples]),
               "inputs": (points, x), "mask": mask,
               # the refinement's inliers: the points the pose is fitted to
               "points": points[choice["mask"]].cpu().numpy()}
    out["pose"] = torch.cat([R, t[:, None]], 1).cpu().numpy().astype(
        np.float64)
    return out


def triangulated(prev, ids, coords, pose_cw, cm, args, device, q):
    """(ids, points) of the tracks (re)triangulated in the frame from
    the program's tracks and pose."""
    k = prev.frame
    first = dict(zip(prev.obs_ids.tolist(), zip(prev.first_frames.tolist(),
                                                prev.first_coords)))
    gaps = dict(zip(prev.map_ids.tolist(), prev.map_gaps.tolist()))
    poses = dict(zip(prev.pose_frames.tolist(), prev.poses))
    sel, frames, xy0 = [], [], []
    for i, tid in enumerate(ids.tolist()):
        j, xy = first.get(tid, (k, None))
        gap = k - j
        if gap >= args["min_track_gap"] and (tid not in gaps
                                             or gap > gaps[tid]):
            sel.append(i)
            frames.append(j)
            xy0.append(xy)
    if not sel:
        return np.zeros(0, np.int64), np.zeros((0, 3), np.float32)
    P0 = q(torch.as_tensor(np.stack([poses[j] for j in frames]),
                           dtype=torch.float32, device=device))
    P1 = q(torch.as_tensor(pose_cw, dtype=torch.float32, device=device))
    points, front = pg.triangulate(
        P0[:, :, :3], P0[:, :, 3], P1[:, :3], P1[:, 3],
        _normalize(cm, np.stack(xy0), device, q),
        _normalize(cm, coords[sel], device, q))
    front = front.cpu().numpy()
    return (ids[sel][front],
            points.cpu().numpy()[front].astype(np.float32))


def reference_frame(prev, image, cm, args, device, program, q,
                    settle=None):
    """The reference's flow, tracks, pose (with its RANSAC's trials and
    its inliers of the program's winning model), map and generator state
    after the frame.  Past each choice that float32's last bits can move
    it takes the program's: the tracks follow the program's flow, the
    pose its RANSAC choice and inliers, the map its tracks and pose
    (``program``: the flow, tracks, pose and RANSAC choice); the tracks'
    ties are settled as the judged side's (``settle``: its ids and
    coords) were."""
    image = q(image)
    if prev.frame == 0:
        return {"tracks": init_tracks(image, args), "pose": np.eye(4)[:3]}
    gen = torch.Generator(device=device)
    gen.set_state(prev.rng_state)
    M = flow(prev, image, args,
             torch.rand((128, 8), generator=gen, device=device), q)
    M_in, ids, coords, pose_in, choice = program
    tracks = track(prev, image, q(M_in), args, settle)
    shape = (256, 8) if prev.frame == 1 else (128, 5)
    draws = torch.rand(shape, generator=gen, device=device)
    out = pose(prev, ids, coords, cm, args, draws, choice, device, q)
    return {**(out or {"pose": None}), "flow": M, "tracks": tracks,
            "rng_state": gen.get_state(),
            "map": triangulated(prev, ids, coords, pose_in, cm, args,
                                device, q)}


def track_gap_pct(a, b):
    (ids_a, xy_a), (ids_b, xy_b) = a, b
    da = dict(zip(ids_a.tolist(), xy_a))
    db = dict(zip(ids_b.tolist(), xy_b))
    union = set(da) | set(db)
    if not union:
        return 0.0
    bad = sum(1 for i in union if i not in da or i not in db
              or np.hypot(*(np.asarray(da[i], np.float64) - db[i]))
              > TRACK_TOL_PX)
    return 100.0 * bad / len(union)


def map_gap_pct(a, b):
    """% of the points (re)triangulated in the frame (the union of both
    sides' ids) that one side wrote and the other did not."""
    ids_a, ids_b = set(a[0].tolist()), set(b[0].tolist())
    union = ids_a | ids_b
    return 100.0 * len(ids_a ^ ids_b) / len(union) if union else 0.0


def map_gap_px(a, b, prev, pose_cw, camera):
    """The 99th percentile over the points that both sides wrote of the
    distance, px, between a point's projections, the larger of the two
    views it was triangulated from (its first observation's and the
    frame's).  A percentile, not the largest: on the card one point of
    a frame has parted by hundreds of pixels while the rest stayed under
    0.04 px."""
    first = dict(zip(prev.obs_ids.tolist(), prev.first_frames.tolist()))
    poses = dict(zip(prev.pose_frames.tolist(), prev.poses))
    da = dict(zip(a[0].tolist(), np.asarray(a[1], np.float64)))
    db = dict(zip(b[0].tolist(), np.asarray(b[1], np.float64)))
    both = sorted(set(da) & set(db))
    if not both:
        return 0.0
    Xa = np.stack([da[i] for i in both])
    Xb = np.stack([db[i] for i in both])
    # the frame's view, then each point's first view
    views = [np.broadcast_to(pose_cw, (len(both), 3, 4)),
             np.stack([poses.get(first.get(i, prev.frame), pose_cw)
                       for i in both])]
    f = min(camera["fx"], camera["fy"])
    gap = np.zeros(len(both))
    for P in views:
        Pa = np.einsum("nij,nj->ni", P[:, :, :3], Xa) + P[:, :, 3]
        Pb = np.einsum("nij,nj->ni", P[:, :, :3], Xb) + P[:, :, 3]
        d = np.linalg.norm(Pa[:, :2] / Pa[:, 2:] - Pb[:, :2] / Pb[:, 2:],
                           axis=1) * f
        d = np.where((Pa[:, 2] > 0) & (Pb[:, 2] > 0) & ~np.isnan(d), d,
                     np.inf)
        gap = np.maximum(gap, d)
    return float(np.percentile(gap, 99))


def pose_gap_px(pose_a, pose_b, points, camera):
    """Largest distance, px, between the projections of ``points``
    (N, 3) under two world -> camera (3, 4) poses; inf where a side has
    no pose."""
    if pose_a is None or pose_b is None:
        return float("inf")
    points = np.asarray(points, np.float64).reshape(-1, 3)
    if not len(points):
        return 0.0 if np.array_equal(pose_a, pose_b) else float("inf")
    f = np.array([camera["fx"], camera["fy"]])
    Pa = points @ pose_a[:, :3].T + pose_a[:, 3]
    Pb = points @ pose_b[:, :3].T + pose_b[:, 3]
    front = (Pa[:, 2] > 0) & (Pb[:, 2] > 0)
    if not front.any():
        return float("inf")
    xa = Pa[front, :2] / Pa[front, 2:] * f
    xb = Pb[front, :2] / Pb[front, 2:] * f
    return float(np.linalg.norm(xa - xb, axis=1).max())


def flow_gap_px(M_a, M_b, coords):
    """Largest distance, px, between the previous tracks moved by two
    affine flows."""
    xy = torch.as_tensor(coords, dtype=torch.float64)
    return float((pf.apply_affine(M_a.cpu().double(), xy)
                  - pf.apply_affine(M_b.cpu().double(), xy)
                  ).norm(dim=-1).max()) if len(xy) else 0.0


def epnp_fit_px(judged, ref, f):
    """The median over PnP's trials of how much worse, in px, the judged
    side's EPnP hypothesis fits the trial's 5 points (its mean
    reprojection distance) than the reference's float64 solution does."""
    points, keypoints = (x.cpu().double() for x in ref["samples"])

    def fit(hyp):
        x, _ = pg.project(*(h.cpu().double() for h in hyp), points)
        return (x - keypoints).norm(dim=-1).mean(-1)
    excess = fit(judged["hyp"]) - fit(ref["hyp"])
    return float(excess.nan_to_num(nan=float("inf")).median()) * f


def ransac_gap_pct(judged, ref, n, args):
    """% of the RANSAC's ``n`` points: on frame 1, the difference
    between the judged side's winning trial's inliers and the
    reference's best trial's on the same draws; on PnP frames, how far
    the judged side's winning trial falls short of its best trial, both
    counted by the reference's arithmetic on the reference's inputs."""
    if "hyp" not in ref:
        return 100.0 * abs(ref["count"] - judged["count"]) / n
    points, x = ref["inputs"]
    Rs, ts = (h.to(points.device, points.dtype) for h in judged["hyp"])
    counts = pg.trial_counts(Rs, ts, points, x, args["pnp_threshold"])
    return 100.0 * float(counts.max() - counts[judged["winner"]]) / n


def inlier_gap_pct(judged, ref):
    """% of the RANSAC's points on which the judged side's inliers of
    the program's winning model (the refit's on frame 1, the
    refinement's after) and the reference's differ."""
    a, b = judged["mask"].to(ref["mask"].device), ref["mask"]
    if a.shape != b.shape:
        return 100.0
    return 100.0 * float((a != b).sum()) / max(len(b), 1)


def judged_program(out, prev, choice, M):
    """The program's side of the check: its outputs and choices."""
    judged = {"tracks": (out.ids, out.coords), "pose": out.pose_cw}
    if prev.frame == 0:
        return judged
    judged.update(flow=M, rng_state=out.rng_state,
                  map=(out.written_ids, out.written_points),
                  mask=choice["mask"])
    if prev.frame == 1:
        judged["count"] = choice["count"]
    else:
        judged.update(hyp=(choice["Rs"], choice["ts"]),
                      winner=choice["best"])
    return judged


def check(captures, loop, config, seed, device, err=None, control=False):
    """The check's numbers of the sampled frames (``NUMBERS``): the
    program's outputs against the reference's, or with ``control`` the
    reference held in bfloat16 against the reference."""
    args = config["app_args"]
    cm = camera_model(config, device)
    device = torch.device(device)
    numbers = {name: {} for name in NUMBERS}
    for k in sorted(captures):
        c = captures[k]
        if "out" not in c or c["out"] is None:
            continue
        prev, out = c["prev"], c["out"]
        image = torch.from_numpy(rgb2gray(loop.frame(k).image)).to(device)
        numbers["track_gap_pct"][k] = float("inf")
        if prev.frame == 0:
            ref = reference_frame(prev, image, cm, args, device, None, _same)
            judged = (reference_frame(prev, image, cm, args, device, None,
                                      bf16) if control else
                      judged_program(out, prev, None, None))
            numbers["track_gap_pct"][k] = track_gap_pct(judged["tracks"],
                                                        ref["tracks"])
            numbers["pose_gap_px"][k] = pose_gap_px(
                judged["pose"], ref["pose"], [], config["camera"])
            continue
        choice = program_choice(out, prev.frame, device)
        M = _probe(out, "flow", "matrix", device)
        if choice is None or M is None:
            for per in numbers.values():
                per[k] = float("inf")     # the port probed too little
            continue
        program = (M, out.ids, out.coords, out.pose_cw, choice)
        judged = (reference_frame(prev, image, cm, args, device, program,
                                  bf16) if control else
                  judged_program(out, prev, choice, M))
        ref = reference_frame(prev, image, cm, args, device, program, _same,
                              judged["tracks"])
        numbers["track_gap_pct"][k] = track_gap_pct(judged["tracks"],
                                                    ref["tracks"])
        points = (out.written_points if prev.frame == 1 else ref["points"])
        numbers["pose_gap_px"][k] = pose_gap_px(judged["pose"], ref["pose"],
                                                points, config["camera"])
        numbers["map_gap_pct"][k] = map_gap_pct(judged["map"], ref["map"])
        numbers["map_gap_px"][k] = map_gap_px(judged["map"], ref["map"],
                                              prev, out.pose_cw,
                                              config["camera"])
        numbers["flow_gap_px"][k] = flow_gap_px(judged["flow"], ref["flow"],
                                                prev.coords)
        numbers["inlier_gap_pct"][k] = inlier_gap_pct(judged, ref)
        if not torch.equal(judged["rng_state"], ref["rng_state"]):
            numbers["ransac_gap_pct"][k] = 100.0
            numbers["epnp_fit_px"][k] = float("inf")
            continue
        numbers["ransac_gap_pct"][k] = ransac_gap_pct(
            judged, ref, max(len(choice["mask"]), 1), args)
        if "hyp" in ref:
            numbers["epnp_fit_px"][k] = epnp_fit_px(judged, ref,
                                                    config["camera"]["fx"])
    tag = "control: " if control else ""
    if err is not None:
        for name, per in numbers.items():
            print(f"[bench_port] {tag}{name} by frame: " + ", ".join(
                f"{k} {v:.4g}" for k, v in sorted(per.items())),
                file=err, flush=True)
    return {name: max(per.values(), default=0.0)
            for name, per in numbers.items()}
