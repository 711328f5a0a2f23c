"""The traced run's readings: the harness's spans and counters over
the window's frames, the profiler's trace of the profiled frames
(``drive.PROFILED``) and the program's own trace of its frames
(``drive.PROGRAM_TRACED``), reduced to what the per-layer metrics read.

Device time is the union of the intervals of every device operation
(kernels, copies, fills) in the profiled frames; the traced window is
the wall span from the first profiled frame's start to the last one's
end, so ``busy_s / window_s`` is the device's busy share.  The profiler
slows the host, so the idle share it reads is an upper bound.  Each
idle gap is named by the innermost program span open where it starts
(the program's spans are the profiler's annotations there), else by the
harness's.

A program span's self time is its duration less what its child spans
cover.
"""

import json
import os
import tempfile
from collections import Counter

# the chrome trace's categories of work on the device; "gpu_user_annotation"
# (a span mirrored on the device's timeline) is none
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HARNESS_SPANS = ("frame", "track", "propagate", "update", "regularize")
NAME_CHARS = 120     # a device operation's name in the breakdown, cut


def union_length(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def merged(intervals):
    """The union of (start, end) intervals as disjoint sorted ones."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_gaps(busy, start, end):
    """The gaps (a, b) in [start, end] that no busy interval covers."""
    gaps, t = [], start
    for a, b in merged(busy):
        if a > t:
            gaps.append((t, min(a, end)))
        t = max(t, b)
    if t < end:
        gaps.append((t, end))
    return [(a, b) for a, b in gaps if b > a]


def innermost(spans, t, default="harness"):
    """Name of the latest-starting span (name, a, b) open at time t."""
    best = None
    for name, a, b in spans:
        if a <= t < b and (best is None or a > best[1]):
            best = (name, a)
    return default if best is None else best[0]


def self_times(spans):
    """(seconds, self seconds) of each span of a closed program trace
    (``tadataka_torch.utils.timing.Span``: name, parent index, ns)."""
    children = [[] for _ in spans]
    for s in spans:
        if s.parent is not None:
            children[s.parent].append((s.t0_ns, s.t1_ns))
    out = []
    for s, kids in zip(spans, children):
        inside = [(max(a, s.t0_ns), min(b, s.t1_ns)) for a, b in kids]
        covered = union_length((a, b) for a, b in inside if b > a)
        length = s.t1_ns - s.t0_ns
        out.append((length * 1e-9, (length - covered) * 1e-9))
    return out


def level_of(spans, i):
    """The pyramid level of the nearest enclosing span that carries one."""
    while i is not None:
        if spans[i].level is not None:
            return spans[i].level
        i = spans[i].parent
    return None


class TraceRecord:
    """What a per-layer metric reads.  Times in seconds.

    ``events``: the profiler's chrome-trace events (:func:`trace_events`),
    or None.  ``frames``: window frames; ``spans[name]``: per-call seconds of a
    harness span over the window's frames that ran without the
    profiler; ``counts[name]``: calls of a counted
    name over the window; ``syncs``: the program's host syncs over the
    ``sync_frames`` frames they were counted on (neither profiled nor
    spanned); ``calls[name]``: the inputs of each call of a name during
    the profiled frames; ``kernels``: (name, start, end) of each device
    operation of the profiled frames; ``profiled``: their number;
    ``busy_s``, ``window_s``: device-busy time and wall span of the
    profiled frames.

    ``program``: the program's trace of ``program_frames`` frames of
    its own (``tadataka_torch.utils.timing.Trace``), or None.
    ``program_spans[name]``: (seconds, self seconds) of each span of
    that name; ``program_counts[name]``: its count over those frames;
    ``program_levels[level]``: the ``dvo.gn_iter`` spans under each
    pyramid level."""

    def __init__(self, rec, events, first_window_frame, frames, profiled,
                 program=None, program_frames=0):
        in_window = range(first_window_frame,
                          first_window_frame + frames)
        first = first_window_frame + profiled[0]
        under_profiler = range(first, first + profiled[1])
        self.frames = frames
        # spans time the frames that ran without the profiler and
        # without sync counting
        self.spans = {name: [s for f, s in v if f in in_window
                             and f not in under_profiler
                             and f not in rec.syncs]
                      for name, v in rec.spans.items()}
        self.counts = {name: sum(n for f, n in v.items() if f in in_window)
                       for name, v in rec.counts.items()}
        # host syncs are counted on frames of their own
        counted = [f for f in rec.syncs if f in in_window]
        self.sync_frames = len(counted)
        self.syncs = sum(rec.syncs[f] for f in counted)
        self.calls = {name: [args for _, args in v]
                      for name, v in rec.calls.items()}
        self.program_frames = program_frames if program is not None else 0
        self.program_spans, self.program_counts = {}, {}
        self.program_levels = Counter()
        if program is not None:
            for i, (s, times) in enumerate(zip(program.spans,
                                               self_times(program.spans))):
                self.program_spans.setdefault(s.name, []).append(times)
                if s.name == "dvo.gn_iter":
                    self.program_levels[level_of(program.spans, i)] += 1
            self.program_counts = {name: sum(v.values())
                                   for name, v in program.counts.items()}
        self.kernels, self.cpu_spans, self.annotations = [], [], []
        self.profiled = 0
        self.busy_s = self.window_s = 0.0
        if events is None:
            return
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            a = float(e["ts"]) * 1e-6
            b = a + float(e["dur"]) * 1e-6
            cat = str(e.get("cat", "")).lower()
            if cat in DEVICE_CATEGORIES:
                self.kernels.append((e.get("name", ""), a, b))
            elif cat == "user_annotation":
                (self.cpu_spans if e.get("name") in HARNESS_SPANS
                 else self.annotations).append((e.get("name", ""), a, b))
        frames_ = [(a, b) for name, a, b in self.cpu_spans if name == "frame"]
        self.profiled = len(frames_)
        if frames_:
            self.t0 = min(a for a, _ in frames_)
            self.t1 = max(b for _, b in frames_)
            self.kernels = [k for k in self.kernels
                            if self.t0 <= k[1] < self.t1]
            self.window_s = self.t1 - self.t0
            self.busy_s = union_length((a, b) for _, a, b in self.kernels)

    def span_mean(self, name):
        v = self.spans.get(name)
        return sum(v) / len(v) if v else None

    def per_frame(self, name):
        return self.counts[name] / self.frames if self.frames and \
            name in self.counts else None

    def program_ms(self, name, self_time=False):
        """Milliseconds a program-traced frame in the spans named
        ``name`` (their self time with ``self_time``); None where none
        ran."""
        v = self.program_spans.get(name)
        if not v or not self.program_frames:
            return None
        return 1e3 * sum(s if self_time else d for d, s in v) / \
            self.program_frames

    def device_time(self, part):
        """Device seconds of the operations whose name holds ``part``
        (a kernel's name may come mangled) in the profiled frames."""
        return sum(b - a for n, a, b in self.kernels if part in n)

    def gaps(self):
        if not self.profiled:
            return []
        busy = [(a, b) for _, a, b in self.kernels]
        return [(innermost(self.annotations, a, None)
                 or innermost(self.cpu_spans, a), b - a)
                for a, b in idle_gaps(busy, self.t0, self.t1)]

    def breakdown(self):
        by_name = Counter()
        for n, a, b in self.kernels:
            by_name[n] += b - a
        gaps = sorted(self.gaps(), key=lambda g: -g[1])
        return {"device_ops": [[n[:NAME_CHARS], t]
                               for n, t in by_name.most_common(10)],
                "idle_gaps": [[n, t] for n, t in gaps[:10]]}

    def lines(self):
        """Lines for standard error: the counts behind the metrics."""
        out = [f"traced: {self.frames} window frames, {self.profiled} "
               f"profiled; host syncs {self.syncs} over {self.sync_frames} "
               f"frames; counts {self.counts}"]
        for name, v in sorted(self.spans.items()):
            out.append(f"span {name}: {len(v)} calls, mean "
                       f"{1e3 * sum(v) / max(len(v), 1):.3f} ms")
        if self.calls:
            out.append("calls kept on the profiled frames: " + ", ".join(
                f"{name} {len(v)}" for name, v in self.calls.items()))
            out.append("device ops named after them: " + ", ".join(
                f"{name} {sum(name in n for n, _, _ in self.kernels)} "
                f"({self.device_time(name):.6f} s)" for name in self.calls))
        if self.profiled:
            out.append(f"profiled frames: {len(self.kernels)} device ops "
                       f"({len(self.kernels) / self.profiled:.1f} a frame), "
                       f"busy {self.busy_s:.6f} s of {self.window_s:.6f} s")
            idle = Counter()
            for name, t in self.gaps():
                idle[name] += t
            out.append("idle by span: " + ", ".join(
                f"{n} {t:.6f} s" for n, t in idle.most_common()))
        out.extend(self.program_lines())
        return out

    def program_lines(self):
        """The program's trace, a frame: the largest self times, the
        Gauss-Newton iterations by level, the host syncs by site and the
        plan cache's hits and misses."""
        n = self.program_frames
        if not n:
            return []
        top = sorted(((self.program_ms(name, True), name)
                      for name in self.program_spans), reverse=True)[:10]
        counts = self.program_counts
        return [
            f"program trace: {n} frames; self ms a frame: " + ", ".join(
                f"{name} {ms:.3f}" for ms, name in top),
            "Gauss-Newton iterations a frame by level: " + ", ".join(
                f"{level} {c / n:.2f}"
                for level, c in sorted(self.program_levels.items(),
                                       key=lambda x: str(x[0]))),
            "host syncs a frame by site: " + ", ".join(
                f"{name} {c / n:.2f}" for name, c in sorted(counts.items())
                if name.startswith("sync.")),
            f"plan cache over {n} frames: hit {counts.get('plan.hit', 0)}, "
            f"miss {counts.get('plan.miss', 0)}"]


def trace_events(prof):
    """The chrome-trace events of a stopped profiler, through the
    trace file kineto writes (in the run's temporary directory, deleted
    at once): parsing it is much faster than the profiler's Python
    events."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
