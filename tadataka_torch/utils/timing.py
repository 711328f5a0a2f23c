"""Spans and counters of the program's work, and the values stages
produce, for measurement scripts.

Code marks a region with ``with span(name):``, a blocking
transfer between host and card with ``with sync_point(name):`` and an
event with ``count(name)``.  Each costs one check while no block is
open (``span`` and ``sync_point`` then return one shared no-op context
manager; a span's attributes are keywords, so a closed mark allocates
nothing).  Inside a ``trace()`` block each span is kept as a
:class:`Span` (name, frame, parent, start and end on
``time.perf_counter_ns``, pyramid level) and each count is added to the
block's counts of the frame in flight::

    with trace() as t:
        vo.estimate(frame)
    t.spans, t.counts   # [Span, ...], {name: {frame: n}}

A span does not synchronize: it is the host's time in the region,
blocking included.  While a profiler records, a span also enters
``torch.profiler.record_function(name)``, so the profiler's trace
holds it as a user annotation beside the card's kernels.  The root span
of an app's frame carries ``frame=``; the spans and counts under it are
filed under that frame.  ``sync_point`` is a span and a count of one
name, around a device-to-host read or a pageable host-to-device copy:
each pass through it is one host synchronization on a card.

Code marks a stage's outputs with ``probe(stage, name=value, ...)``.
That costs one check while no ``capture()`` block is open; inside it,
each value is copied to the host and appended to the block's list as
``(stage, name, numpy array)``, in the order the code produced them, so
that two runs (on the CPU and on the card) can be compared entry by
entry::

    with capture() as values:
        vo.estimate(frame)

``capture(stages=(...))`` keeps only the named stages' values; the
other probes copy nothing.
"""

import time
from contextlib import contextmanager

import numpy as np
import torch

_trace = None    # the open trace() block (a Trace)
_values = None   # the open capture() block's list
_stages = None   # the stages it keeps (None: all)


class _Noop:
    """What a mark returns while no block is open."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class Span:
    """One region the host ran through: ``parent`` is the index of the
    enclosing span in the block's list (None at the top), ``frame`` the
    app's frame it belongs to (None outside a frame), times in ns on
    ``time.perf_counter_ns``, ``level`` the pyramid level of a DVO level
    span (else None)."""

    __slots__ = ("name", "frame", "parent", "t0_ns", "t1_ns", "level")

    def __init__(self, name, frame, parent, level):
        self.name, self.frame, self.parent = name, frame, parent
        self.level = level
        self.t0_ns = self.t1_ns = None


class Trace:
    """The spans and counts of an open block."""

    def __init__(self):
        self.spans = []
        self.counts = {}      # name -> {frame: n}
        self.frame = None     # the frame in flight
        self._stack = []      # indices of the open spans, innermost last


class _Open:
    """A span of an open block, as a context manager."""

    __slots__ = ("trace", "name", "frame", "level", "span", "annotation",
                 "outer_frame")

    def __init__(self, trace, name, frame=None, level=None):
        self.trace, self.name = trace, name
        self.frame, self.level = frame, level
        self.span = self.annotation = self.outer_frame = None

    def __enter__(self):
        t = self.trace
        s = self.span = Span(
            self.name, t.frame if self.frame is None else self.frame,
            t._stack[-1] if t._stack else None, self.level)
        t._stack.append(len(t.spans))
        t.spans.append(s)
        self.outer_frame, t.frame = t.frame, s.frame
        if torch._C._autograd._profiler_enabled():
            self.annotation = torch.profiler.record_function(s.name)
            self.annotation.__enter__()
        s.t0_ns = time.perf_counter_ns()
        return s

    def __exit__(self, *exc):
        t, s = self.trace, self.span
        s.t1_ns = time.perf_counter_ns()
        if self.annotation is not None:
            self.annotation.__exit__(None, None, None)
        t._stack.pop()
        t.frame = self.outer_frame
        return False


def span(name, frame=None, level=None):
    """A region of the program's work, kept inside a ``trace()`` block;
    ``frame`` (on an app's root span) files it and what runs under it
    under that frame; ``level``: a DVO pyramid level."""
    t = _trace
    if t is None:
        return _NOOP
    return _Open(t, name, frame, level)


def count(name, n=1):
    """Add ``n`` to the open block's count of ``name`` for the frame in
    flight."""
    t = _trace
    if t is None:
        return
    per = t.counts.get(name)
    if per is None:
        per = t.counts[name] = {}
    per[t.frame] = per.get(t.frame, 0) + n


def sync_point(name, n=1):
    """A span and a count of ``name`` (``sync.<site>``) around a
    blocking transfer between host and card; ``n``: the transfers it
    holds."""
    t = _trace
    if t is None:
        return _NOOP
    count(name, n)
    return _Open(t, name)


def tracing():
    """Whether a ``trace()`` block is open."""
    return _trace is not None


@contextmanager
def trace():
    """A :class:`Trace` of the spans and counts run inside the block;
    nothing synchronizes."""
    global _trace
    block = Trace()
    outer, _trace = _trace, block
    try:
        yield block
    finally:
        _trace = outer


@contextmanager
def capture(stages=None):
    """A list of (stage, name, value) of the values probed inside the
    block; ``stages``: keep only those stages' (the others' probes then
    copy nothing)."""
    global _values, _stages
    _values, _stages = [], stages
    try:
        yield _values
    finally:
        _values = _stages = None


def probe(stage, **values):
    """Inside a ``capture()`` block, append each value's host copy."""
    if _values is None or (_stages is not None and stage not in _stages):
        return
    for name, value in values.items():
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        _values.append((stage, name, np.asarray(value)))
