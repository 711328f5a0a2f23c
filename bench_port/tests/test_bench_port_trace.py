"""The traced run's arithmetic on canned intervals: busy time as the
union of device intervals, idle gaps and their labels, and the
metrics that read them."""

import pytest

from bench_port.harness.spec import metric_reader
from bench_port.harness.trace import (
    TraceRecord, idle_gaps, innermost, merged, union_length)


def test_union_length_counts_overlaps_once():
    assert union_length([]) == 0.0
    assert union_length([(0, 1), (0.5, 2), (3, 4)]) == pytest.approx(3.0)
    assert union_length([(0, 10), (1, 2), (3, 4)]) == pytest.approx(10.0)
    assert merged([(3, 4), (0, 1), (0.5, 2)]) == [[0, 2], [3, 4]]


def test_idle_gaps_and_labels():
    busy = [(1, 2), (1.5, 3), (5, 6)]
    assert idle_gaps(busy, 0, 8) == [(0, 1), (3, 5), (6, 8)]
    spans = [("frame", 0, 8), ("track", 0.5, 4), ("update", 4, 7)]
    assert innermost(spans, 0.2) == "frame"
    assert innermost(spans, 3.0) == "track"
    assert innermost(spans, 6.5) == "update"
    assert innermost(spans, 9.0) == "harness"


def _event(name, a_us, b_us, cat):
    return {"ph": "X", "name": name, "ts": a_us, "dur": b_us - a_us,
            "cat": cat}


class _Rec:
    # frame 3 is warm-up, frames 12-13 ran under the profiler
    spans = {"track": [(10, 0.02), (11, 0.04), (3, 9.0), (12, 5.0)]}
    counts = {"normal_equations": {10: 30, 11: 50, 3: 1000}}
    syncs = {12: 80, 13: 100}      # counted on the profiled frames
    calls = {}


def test_record_reduces_to_the_metrics():
    # two profiled frames of 100 us each, kernels busy 30 us and 20 us
    events = [_event("frame", 0, 100, "user_annotation"),
              _event("frame", 100, 200, "user_annotation"),
              _event("track", 10, 60, "user_annotation"),
              _event("k1", 10, 30, "kernel"), _event("k2", 20, 40, "kernel"),
              _event("_Z22ssd_search_ring_kernel14CUtensorMap_st", 150, 170,
                     "kernel"),
              _event("late", 500, 600, "kernel"),
              _event("aten::add", 0, 200, "cpu_op")]
    # a span mirrored on the device's timeline is no device work
    events.append(_event("frame", 0, 100, "gpu_user_annotation"))
    record = TraceRecord(_Rec(), events, 10, 4, (2, 2))
    assert record.frames == 4 and record.profiled == 2
    assert record.busy_s == pytest.approx(50e-6)
    assert record.window_s == pytest.approx(200e-6)
    assert metric_reader("device_idle").read(record) == pytest.approx(75.0)
    assert metric_reader("track_ms").read(record) == pytest.approx(30.0)
    assert metric_reader("gn_iters_per_frame").read(record) == 20
    assert metric_reader("host_syncs_per_frame").read(record) == 90
    assert metric_reader("update_ms").read(record) is None
    # no ssd_search calls were kept: the roofline reads nothing
    assert metric_reader("ssd_search_roofline").read(record) is None
    assert record.device_time("ssd_search") == pytest.approx(20e-6)
    gaps = record.breakdown()["idle_gaps"]
    # a gap takes the label of the span open where it starts
    assert gaps[0] == ["track", pytest.approx(110e-6)]
    assert ["frame", pytest.approx(30e-6)] in gaps
    assert ["frame", pytest.approx(10e-6)] in gaps


def test_untraced_record_reads_nothing_from_the_device():
    record = TraceRecord(_Rec(), None, 10, 2, (2, 2))
    assert metric_reader("device_idle").read(record) is None
    assert record.breakdown() == {"device_ops": [], "idle_gaps": []}
