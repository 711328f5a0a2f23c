"""The program's own trace in a traced run: opened on window frames of
its own (no harness span, no sync counting, no profiler there), reduced
to spans with their self times and to counts, read by the per-layer
metrics, and naming the idle gaps it covers."""

import io

import pytest

from bench_port.harness import drive
from bench_port.harness import trace as trace_mod
from bench_port.harness.record import Recorder
from bench_port.harness.spec import metric_reader
from bench_port.harness.trace import TraceRecord, self_times
from bench_port.tests.small import small

NEW_READERS = ("solve_host_ms", "sweep_host_ms", "plan_host_ms",
               "sync_wait_ms", "graph_replay_share")


def test_the_stretches_are_disjoint():
    frames = [set(range(a, a + n)) for a, n in (
        drive.PROFILED, drive.SYNC_COUNTED, drive.PROGRAM_TRACED)]
    assert sum(map(len, frames)) == len(set.union(*frames))
    assert drive.within(drive.PROGRAM_TRACED, drive.PROGRAM_TRACED[0])
    assert not drive.within(drive.PROGRAM_TRACED, sum(drive.PROGRAM_TRACED))


class _Program:
    """A hand-built program trace: two frames, ns from 0."""

    def __init__(self):
        from tadataka_torch.utils.timing import Span

        def span(name, parent, t0, t1, level=None):
            s = Span(name, 0, parent, level)
            s.t0_ns, s.t1_ns = t0, t1
            return s
        # frame: 0..100 ms; a level of 80 ms holds two iterations of
        # 30 ms (one with a 10 ms solve and a 5 ms sync) and a sync that
        # overlaps nothing
        ms = 1_000_000
        self.spans = [
            span("dvo.estimate", None, 0, 100 * ms),         # 0
            span("dvo.level", 0, 10 * ms, 90 * ms, level=2),  # 1
            span("dvo.gn_iter", 1, 10 * ms, 40 * ms),        # 2
            span("dvo.solve", 2, 20 * ms, 30 * ms),          # 3
            span("sync.dvo.sums", 2, 12 * ms, 17 * ms),      # 4
            span("dvo.gn_iter", 1, 40 * ms, 70 * ms),        # 5
            span("dvo.solve", 5, 50 * ms, 56 * ms),          # 6
            span("sync.sd.drain", 0, 92 * ms, 94 * ms),      # 7
        ]
        self.counts = {"dvo.gn_iter": {0: 2, 1: 2},
                       "dvo.graph_replay": {0: 2, 1: 1},
                       "sync.dvo.sums": {0: 1}}


class _Rec:
    spans, counts, syncs, calls = {}, {}, {}, {}


def test_self_time_of_a_hand_built_tree():
    program = _Program()
    times = [(round(d * 1e3, 9), round(s * 1e3, 9))
             for d, s in self_times(program.spans)]
    assert times == [(100, 100 - 80 - 2), (80, 80 - 60), (30, 30 - 15),
                     (10, 10), (5, 5), (30, 24), (6, 6), (2, 2)]
    record = TraceRecord(_Rec(), None, 10, 4, (2, 2), program, 2)
    assert record.program_frames == 2
    assert record.program_counts == {"dvo.gn_iter": 4, "dvo.graph_replay": 3,
                                     "sync.dvo.sums": 1}
    assert record.program_levels == {2: 2}
    read = {name: metric_reader(name).read(record) for name in NEW_READERS}
    assert read["solve_host_ms"] == pytest.approx(8.0)
    assert read["sync_wait_ms"] == pytest.approx(3.5)
    assert read["graph_replay_share"] == pytest.approx(75.0)
    assert read["sweep_host_ms"] is None and read["plan_host_ms"] is None
    assert record.program_ms("dvo.gn_iter", self_time=True) == \
        pytest.approx(19.5)
    assert any("Gauss-Newton iterations a frame by level: 2 1.00" in line
               for line in record.lines())


def test_readers_read_nothing_without_the_marks():
    for program in (None, type("Empty", (), {"spans": [], "counts": {}})()):
        record = TraceRecord(_Rec(), None, 10, 4, (2, 2), program, 3)
        for name in NEW_READERS:
            assert metric_reader(name).read(record) is None, name


def _event(name, a_us, b_us, cat):
    return {"ph": "X", "name": name, "ts": a_us, "dur": b_us - a_us,
            "cat": cat}


def test_an_idle_gap_under_a_program_span_takes_its_name():
    events = [_event("frame", 0, 100, "user_annotation"),
              _event("track", 1, 60, "user_annotation"),
              _event("dvo.level", 5, 55, "user_annotation"),
              _event("dvo.solve", 20, 30, "user_annotation"),
              _event("sd.update", 60, 100, "user_annotation"),
              _event("k1", 0, 20, "kernel"), _event("k2", 35, 50, "kernel"),
              _event("k3", 55, 58, "kernel"), _event("k4", 62, 65, "kernel"),
              _event("k5", 75, 100, "kernel")]
    record = TraceRecord(_Rec(), events, 10, 1, (0, 1))
    assert record.busy_s == pytest.approx(66e-6)
    gaps = dict((n, t) for n, t in record.breakdown()["idle_gaps"])
    # 20-35 starts under dvo.solve, 50-55 under dvo.level, 58-62 under
    # the harness's track alone, 65-75 under sd.update
    assert gaps == {"dvo.solve": pytest.approx(15e-6),
                    "dvo.level": pytest.approx(5e-6),
                    "track": pytest.approx(4e-6),
                    "sd.update": pytest.approx(10e-6)}


@pytest.fixture
def traced_run(monkeypatch):
    """A small traced CPU run of a cell with short stretches; yields
    (result, record, the state of the recorder on each window frame)."""
    kept, states = [], {}

    class Keep(TraceRecord):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            kept.append(self)
    monkeypatch.setattr(trace_mod, "TraceRecord", Keep)
    monkeypatch.setattr(drive, "SYNC_COUNTED", (1, 1))
    real_scope = Recorder.frame_scope

    def scope(rec, frame, capture):
        from tadataka_torch.utils import timing
        states[frame] = dict(spans_on=rec.spans_on,
                             count_syncs=rec.count_syncs,
                             keep_calls=rec.keep_calls,
                             program=timing.tracing())
        return real_scope(rec, frame, capture)
    monkeypatch.setattr(Recorder, "frame_scope", scope)

    def run(cell, program_traced, seconds):
        monkeypatch.setattr(drive, "PROGRAM_TRACED", program_traced)
        result = drive.run(cell, 2**31 + 41, seconds, True, device="cpu",
                           config_override=small, out=io.StringIO(),
                           err=io.StringIO())
        return result, kept[-1], states
    return run


def test_dvo_program_frames_hold_no_harness_span(traced_run):
    # window frames 2..6 would be profiled on a card, 1 sync-counted
    result, record, states = traced_run("dvo-fr1-forward", (7, 2), 2.0)
    assert result["correct"]
    warm = 6             # apps/dvo_trajectory.py's WARM_FRAMES
    window = sorted(f for f in states if f >= warm)
    assert len(window) == result["attempted"] >= 9
    traced = [f for f in window if states[f]["program"]]
    assert [f - warm for f in traced] == [7, 8]
    assert record.program_frames == 2
    for f in traced:
        assert not states[f]["spans_on"] and not states[f]["count_syncs"]
        assert not states[f]["keep_calls"]
    assert all(states[f]["spans_on"] for f in states if f not in traced)
    assert not any(states[f]["program"] for f in range(warm))
    # the harness's track span timed every window frame but the
    # profiler's and the program's
    assert len(record.spans["track"]) == len(window) - drive.PROFILED[1] - 2
    metrics = result["metrics"]
    assert metrics["solve_host_ms"]["value"] > 0
    assert metrics["sync_wait_ms"]["value"] > 0
    assert metrics["graph_replay_share"]["value"] == 0.0   # eager on a CPU
    assert "sweep_host_ms" not in metrics          # not listed for the cell
    assert record.program_counts["dvo.gn_iter"] == sum(
        record.program_levels.values())
    from tadataka_torch.utils import timing
    assert not timing.tracing()                    # the block was closed


def test_semi_dense_readers_on_a_cpu_run(traced_run):
    result, record, states = traced_run("sd-fr1-forward", (0, 1), 0.5)
    assert result["correct"] and record.program_frames == 1
    metrics = result["metrics"]
    for name in NEW_READERS:
        assert name in metrics, name
    assert metrics["sweep_host_ms"]["value"] > 0
    assert metrics["plan_host_ms"]["value"] > 0
    counts = record.program_counts
    assert counts.get("plan.hit", 0) + counts.get("plan.miss", 0) == 1
    # the first window frame ran in the program's trace: no harness span
    timed = [w for w in range(1, result["attempted"])
             if not drive.within(drive.PROFILED, w)]
    assert len(record.spans.get("update", [])) == len(timed)
