"""The port's spans and counters (``tadataka_torch/utils/timing.py``) on
the CPU: closed marks are one shared no-op, the span tree of both apps'
frames, Gauss-Newton iterations, plan-cache hits and misses and host
syncs by call site counted as the code runs them, the same bits with
the block open and closed, and each span mirrored as a profiler
annotation."""

import contextlib
import itertools
import json
import tracemalloc

import numpy as np
import pytest
import torch

import tadataka_torch.vo.dvo as dvo
from tadataka_torch.core.pose import Pose
from tadataka_torch.utils import timing
from tadataka_torch.utils.timing import count, span, sync_point, trace

N_LEVELS = 3


def semi_dense_scene(n_frames=3, step=(0.18, 0.01)):
    """The 3-frame 40x56 scene of ``test_torch_aux``'s metrics test; a
    ``step`` of zeros holds the camera still."""
    from tadataka_torch.apps.semi_dense_vo import SemiDenseVO
    from tadataka_torch.camera import CameraParameters
    from tadataka_torch.dataset import multi_plane_scene
    from tadataka_torch.vo.semi_dense import SemiDenseParams
    poses = [Pose.from_rotvec(torch.tensor([0.0, 0.002 * i, 0.0]),
                              torch.tensor([step[0] * i, step[1] * i, 0.0]))
             for i in range(n_frames)]
    ds = multi_plane_scene(n_frames, (40, 56), (40.0, 40.0), poses)
    vo = SemiDenseVO(CameraParameters.create((40.0, 40.0), (28.0, 20.0)),
                     params=SemiDenseParams.create(2.0, 50.0,
                                                   ref_step_size=0.002,
                                                   min_gradient=0.01),
                     n_coarse_to_fine=N_LEVELS, history_size=3,
                     device="cpu")
    vo.initial_pose_fn = lambda a, b: ds[1].pose.inv() * ds[0].pose
    return vo, [ds[i] for i in range(n_frames)]


def dvo_scene():
    """DvoTrajectory on a 3-frame 48x64 plane scene."""
    from tadataka_torch.apps.dvo_trajectory import DvoTrajectory
    from tadataka_torch.dataset.synthetic import PlaneSceneDataset
    poses = [Pose.from_rotvec(torch.zeros(3),
                              torch.tensor([0.05 * i, 0.0, 0.0]))
             for i in range(3)]
    ds = PlaneSceneDataset(len(poses), image_shape=(48, 64), poses=poses,
                           focal_length=(48.0, 48.0))
    est = DvoTrajectory(ds.camera_model, n_coarse_to_fine=N_LEVELS,
                        max_iter=3, device="cpu")
    return est, [ds[i] for i in range(3)]


SCENES = {"sd": semi_dense_scene, "dvo": dvo_scene}


def run(app, traced):
    """(outputs of every frame, the Trace or None)."""
    vo, frames = SCENES[app]()
    if not traced:
        return [vo.estimate(f) for f in frames], None
    with trace() as t:
        outs = [vo.estimate(f) for f in frames]
    return outs, t


def ancestors(spans, i):
    while spans[i].parent is not None:
        i = spans[i].parent
        yield spans[i]


def test_closed_marks_are_one_shared_noop():
    assert timing._trace is None
    assert span("a") is span("b", frame=3, level=1) is timing._NOOP
    assert sync_point("sync.a") is timing._NOOP
    assert count("a") is None

    def marks():
        for _ in itertools.repeat(None, 1000):
            with span("dvo.level", level=2), span("dvo.gn_iter"):
                count("dvo.gn_iter")
                with sync_point("sync.dvo.sums"), span("extract"):
                    pass

    noop = timing._NOOP

    def bare():
        """The same ``with`` statements on the no-op itself: what the
        interpreter allocates for them (a bound ``__exit__``)."""
        for _ in itertools.repeat(None, 1000):
            with noop, noop:
                with noop, noop:
                    pass

    peaks = []
    for fn in (bare, marks):
        fn()
        tracemalloc.start()
        try:
            fn()
            peaks.append(tracemalloc.get_traced_memory())
        finally:
            tracemalloc.stop()
    assert peaks[1] == peaks[0]


@pytest.mark.parametrize("app", ["sd", "dvo"])
def test_span_tree_one_root_a_frame(app):
    """Each child lies inside its parent and shares its frame; one root
    a frame, carrying the frame's number; the pyramid's level and
    iteration spans lie under the app's track span."""
    _, t = run(app, traced=True)
    spans = t.spans
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == [f"{app}.estimate"] * 3
    assert [s.frame for s in roots] == [0, 1, 2]
    for i, s in enumerate(spans):
        assert s.t0_ns <= s.t1_ns
        if s.parent is not None:
            p = spans[s.parent]
            assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns
            assert s.frame == p.frame and s.parent < i
    levels = [s for s in spans if s.name == "dvo.level"]
    # the semi-dense app bootstraps frame 1: only frame 2 tracks there
    tracked = [2] if app == "sd" else [1, 2]
    assert [s.frame for s in levels] == [f for f in tracked
                                         for _ in range(N_LEVELS)]
    assert [s.level for s in levels] == list(
        reversed(range(N_LEVELS))) * len(tracked)
    for i, s in enumerate(spans):
        if s.name in ("dvo.level", "dvo.gn_iter", "dvo.solve"):
            assert f"{app}.track" in [a.name for a in ancestors(spans, i)]
    iters = [s for s in spans if s.name == "dvo.gn_iter"]
    assert all(spans[s.parent].name == "dvo.level" for s in iters)
    names = {s.name for s in spans}
    stages = ({"sd.prepare", "sd.track", "sd.propagate",
               "sd.plan", "sd.update", "sd.sweep", "sd.regularize",
               "sd.push"} if app == "sd" else
              {"dvo.prepare", "dvo.track", "dvo.compose"})
    assert stages <= names
    if app == "sd":
        reg = [i for i, s in enumerate(spans) if s.name == "sd.regularize"]
        assert reg and all("sd.update" in [a.name for a in ancestors(
            spans, i)] for i in reg)


@pytest.mark.parametrize("app", ["sd", "dvo"])
def test_gn_iter_counts_normal_equations(app, monkeypatch):
    """``dvo.gn_iter`` over each frame equals that frame's calls of
    ``vo/dvo.py::_normal_equations``."""
    calls = {}
    real = dvo._normal_equations

    def counted(*args):
        frame = timing._trace.frame
        calls[frame] = calls.get(frame, 0) + 1
        return real(*args)

    monkeypatch.setattr(dvo, "_normal_equations", counted)
    _, t = run(app, traced=True)
    assert t.counts["dvo.gn_iter"] == calls
    assert sum(calls.values()) > 2 * N_LEVELS
    iters = [s for s in t.spans if s.name == "dvo.gn_iter"]
    assert len(iters) == sum(calls.values())


def test_sync_points_count_each_transfer():
    """DVO's host syncs by site, a tracked frame: one an iteration (the
    sums; the pose goes to a card without blocking), six a level, the
    image and depth uploads; each counted site has its spans."""
    _, t = run("dvo", traced=True)
    c = t.counts
    assert "sync.dvo.pose_to_card" not in c
    for f in (1, 2):
        iters = c["dvo.gn_iter"][f]
        assert c["sync.dvo.sums"][f] == iters
        for site in ("pose_to_host", "best_to_card", "upper_index"):
            assert c[f"sync.dvo.{site}"][f] == 2 * N_LEVELS
        assert c["sync.dvo.image_upload"][f] == 2
    assert set(c["sync.dvo.image_upload"]) == {0, 1, 2}
    named = {s.name for s in t.spans if s.name.startswith("sync.")}
    assert named == {n for n in c if n.startswith("sync.")}


def test_plan_hits_and_misses_count_the_frames_planned():
    """``plan.hit + plan.miss`` is one a planned frame (every frame past
    the first); a camera held still hits the memo once the history is
    full.  The host pose chain drains its four pending poses on frame
    6, one sync each."""
    vo, frames = semi_dense_scene(n_frames=7, step=(0.0, 0.0))
    planned = []
    real_plan = vo._plan

    def plan(key_T_pred):
        planned.append(timing._trace.frame)
        return real_plan(key_T_pred)

    vo._plan = plan
    with trace() as t:
        for f in frames:
            vo.estimate(f)
    hits = t.counts.get("plan.hit", {})
    misses = t.counts.get("plan.miss", {})
    assert planned == [1, 2, 3, 4, 5, 6]
    assert {f: hits.get(f, 0) + misses.get(f, 0) for f in planned} == \
        dict.fromkeys(planned, 1)
    assert sum(hits.values()) >= 1
    assert [s.frame for s in t.spans if s.name == "sd.plan"] == planned
    assert [s.frame for s in t.spans if s.name == "sd.drain"] == [6]
    assert t.counts["sync.sd.drain"] == {6: 4}


@pytest.mark.parametrize("app", ["sd", "dvo"])
def test_tracing_changes_no_bit(app):
    outs, _ = run(app, traced=False)
    traced, _ = run(app, traced=True)
    for a, b in zip(outs, traced):
        if app == "dvo":
            assert torch.equal(a.R, b.R) and torch.equal(a.t, b.t)
            continue
        assert torch.equal(a.pose_wc.T, b.pose_wc.T)
        for name in ("depth_map", "variance_map", "age_map", "flag_map"):
            x, y = getattr(a, name), getattr(b, name)
            assert (x is None and y is None) or torch.equal(x, y), name


def test_spans_are_profiler_annotations(tmp_path):
    """Under ``torch.profiler`` each span of the block is a user
    annotation of the same name, in the same order."""
    from torch.profiler import ProfilerActivity, profile
    est, frames = dvo_scene()
    with profile(activities=[ProfilerActivity.CPU]) as prof, trace() as t:
        for f in frames:
            est.estimate(f)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    ours = {s.name for s in t.spans}
    notes = sorted((float(e["ts"]), -float(e["dur"]), e["name"])
                   for e in events
                   if e.get("cat") == "user_annotation"
                   and e.get("name") in ours)
    assert [n for _, _, n in notes] == [s.name for s in t.spans]


def test_profile_trace_exports_the_programs_spans(tmp_path):
    """``observability.profile_trace`` traces the program's spans, so its
    Chrome trace holds one root annotation a frame."""
    from tadataka_torch.utils.observability import profile_trace
    est, frames = dvo_scene()
    with profile_trace(tmp_path):
        for f in frames:
            est.estimate(f)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert names.count("dvo.estimate") == 3
    assert names.count("dvo.level") == 2 * N_LEVELS
    assert timing._trace is None


def vitamin_e_scene(n_frames=3):
    """VitaminEVO on a 3-frame 120x160 multi-plane scene: frame 0 the
    extrema, frame 1 the bootstrap, frame 2 PnP."""
    from tadataka_torch.dataset import multi_plane_scene
    from tadataka_torch.vo.vitamin_e import VitaminEVO
    poses = [Pose.from_rotvec(torch.tensor([0.0, 0.003 * i, 0.0]),
                              torch.tensor([0.15 * i, 0.01 * i, 0.0]))
             for i in range(n_frames)]
    ds = multi_plane_scene(n_frames, (120, 160), (120.0, 120.0), poses)
    vo = VitaminEVO(ds[0].camera_model, fast_threshold=0.02, patch_size=24,
                    device="cpu")
    return vo, [ds[i].image for i in range(n_frames)]


def vitamin_e_run(traced):
    """(the VO after its frames, each frame's pose, the map's ids after
    each frame, the Trace or None)."""
    vo, images = vitamin_e_scene()
    poses, maps = [], []
    with (trace() if traced else contextlib.nullcontext()) as t:
        for im in images:
            poses.append(vo.estimate(im))
            maps.append(set(vo.points))
    return vo, poses, maps, t


@pytest.fixture(scope="module")
def vitamin_e_traced():
    return vitamin_e_run(traced=True)


def test_vitamin_e_spans_syncs_and_counters(vitamin_e_traced):
    """``ve.estimate`` roots each frame with its index, the stages and
    every ``sync.ve.*`` site sit under it, and the four counters count
    what the VO kept: tracks carried in and spawned make the frame's
    keypoints, PnP reads the mapped tracks, the points written fill the
    map."""
    vo, poses, maps, t = vitamin_e_traced
    assert all(p is not None for p in poses)
    roots = [s for s in t.spans if s.name == "ve.estimate"]
    assert [s.frame for s in roots] == [0, 1, 2]
    assert all(s.parent is None for s in roots)
    for i, s in enumerate(t.spans):
        if s.name != "ve.estimate":
            assert any(a.name == "ve.estimate" for a in ancestors(t.spans, i))

    def frames_of(name):
        return sorted({s.frame for s in t.spans if s.name == name})
    assert frames_of("extract") == [0, 1, 2]
    for name in ("flow", "curvature + climb", "new area", "pose",
                 "triangulate"):
        assert frames_of(name) == [1, 2], name
    assert frames_of("Gauss-Newton") == [2]
    c = t.counts
    assert c["sync.ve.extrema"] == {0: 1}
    for site in ("matches", "tracks", "pose", "triangulate"):
        assert c[f"sync.ve.{site}"] == {1: 1, 2: 1}, site
    # the curvature's percentile reads its two 0-d indices: the extrema
    # of frame 0, the new area's of later frames
    assert c["sync.curvature.percentile"] == {0: 2, 1: 2, 2: 2}
    named = {s.name for s in t.spans if s.name.startswith("sync.")}
    assert named == {n for n in c if n.startswith("sync.")}
    for f in (1, 2):
        assert c["ve.tracked"][f] + c["ve.spawned"][f] == \
            len(vo.keypoints[f].ids)
        assert c["ve.tracked"][f] == len(np.intersect1d(
            vo.keypoints[f - 1].ids, vo.keypoints[f].ids))
    assert set(c["ve.pnp_points"]) == {2}
    assert c["ve.pnp_points"][2] == sum(tid in maps[1]
                                        for tid in vo.keypoints[2].ids)
    # frame 1 writes every point it maps; frame 2 rewrites the old ones
    # and adds the tracks first seen on frame 1
    assert c["ve.triangulated"][1] == len(maps[1])
    assert maps[1] <= maps[2]
    assert len(maps[2] - maps[1]) <= c["ve.triangulated"][2] <= \
        len(vo.keypoints[2].ids)


def test_vitamin_e_tracing_changes_no_bit(vitamin_e_traced):
    vo, poses, _, _ = vitamin_e_traced
    plain_vo, plain_poses, _, _ = vitamin_e_run(traced=False)
    for a, b in zip(poses, plain_poses):
        assert torch.equal(a.R, b.R) and torch.equal(a.t, b.t)
    for a, b in zip(vo.keypoints, plain_vo.keypoints):
        assert np.array_equal(a.ids, b.ids)
        assert np.array_equal(a.coords, b.coords)
    assert sorted(vo.points) == sorted(plain_vo.points)
    assert all(np.array_equal(vo.points[i], plain_vo.points[i])
               for i in vo.points)


def test_vitamin_e_marks_are_no_ops_with_no_block_open(monkeypatch):
    """With no block open no mark of the VO makes a span or counts."""
    def refuse(*args, **kwargs):
        raise AssertionError("a mark opened a span with no block open")
    monkeypatch.setattr(timing, "_Open", refuse)
    assert timing._trace is None
    vo, images = vitamin_e_scene()
    assert all(vo.estimate(im) is not None for im in images)


def test_capture_keeps_only_the_named_stages():
    """``capture(stages)`` keeps the named stages' probes, the same
    values in the same order as an open capture, and no other."""
    kept = ("flow", "RANSAC pnp")
    runs = []
    for stages in (None, kept):
        vo, images = vitamin_e_scene()
        with timing.capture(stages) as values:
            for im in images:
                vo.estimate(im)
        runs.append(values)
    every, named = runs
    assert {stage for stage, _, _ in every} > set(kept)
    assert {stage for stage, _, _ in named} == set(kept)
    wanted = [v for v in every if v[0] in kept]
    assert [(s, n) for s, n, _ in named] == [(s, n) for s, n, _ in wanted]
    assert all(np.array_equal(a[2], b[2]) for a, b in zip(named, wanted))
    assert timing._stages is None and timing._values is None
