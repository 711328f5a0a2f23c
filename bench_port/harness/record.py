"""The instrumentation of a run, from the benchmark's own files: names
that the port's apps call are replaced, for the run, by wrappers that
time them (spans), count them (counters), keep their inputs (calls)
and keep the inputs and outputs of the frames sampled for the check
(captures).  The port's code is not edited.

Spans and host-sync counts exist only in a traced run: a span
synchronizes the device at both ends, and host syncs are counted, on a
few frames of their own (counting slows the host), by
``torch.cuda.set_sync_debug_mode("warn")`` while the program runs, with
the harness's own synchronizations left out.  ``spans_on`` turns the
spans off on frames where the program's own trace reads the host's
times, which a synchronization would move.  Captures hold
references to the program's tensors, never copies, and exist in every
run, since every run is checked."""

import time
import warnings
from contextlib import contextmanager

import numpy as np
import torch


def copy_of(x):
    """A copy of a call's arguments or result: tensors cloned, arrays
    copied, through tuples (named ones too), lists and dicts."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, np.ndarray):
        return x.copy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(copy_of(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(copy_of(v) for v in x)
    if isinstance(x, dict):
        return {k: copy_of(v) for k, v in x.items()}
    return x


class Recorder:
    def __init__(self, device, trace):
        self.device = torch.device(device)
        self.trace = trace
        self.frame = None         # index of the frame in flight
        self.capturing = False    # the frame in flight is sampled
        self.keep_calls = False   # keep wrapped calls' inputs (profiled frames)
        self.spans_on = True      # time the spans (traced runs)
        self.count_syncs = False  # count the program's host syncs
        self.spans = {}           # name -> [(frame, seconds)]
        self.counts = {}          # name -> {frame: calls}
        self.calls = {}           # name -> [(frame, args)]
        self.captures = {}        # frame -> {name: (args, kwargs, out)}
        self.syncs = {}           # frame -> host syncs the program made
        self._wrapped = []
        self._counting = False

    # --------------------------------------------------------- wrapping

    def wrap(self, module, attr, name, span=False, count=False,
             capture=False, calls=False):
        """Replace ``module.attr`` by a wrapper for the run."""
        real = getattr(module, attr)
        recorder = self

        def wrapper(*args, **kwargs):
            frame = recorder.frame
            if count and frame is not None:
                per = recorder.counts.setdefault(name, {})
                per[frame] = per.get(frame, 0) + 1
            if calls and recorder.keep_calls:
                recorder.calls.setdefault(name, []).append((frame, args))
            if span and recorder.trace and recorder.spans_on and \
                    frame is not None:
                with recorder.span(name):
                    out = real(*args, **kwargs)
            else:
                out = real(*args, **kwargs)
            if capture and recorder.capturing:
                recorder.captures.setdefault(frame, {})[name] = copy_of(
                    (args, kwargs, out))
            return out

        # attributes of the real function (ssd_search.launches) stay
        # reachable through the module's name
        wrapper.__wrapped__ = real
        for key, value in getattr(real, "__dict__", {}).items():
            setattr(wrapper, key, value)
        self.wrap_callable(module, attr, wrapper)

    def wrap_callable(self, owner, attr, wrapper):
        """Replace ``owner.attr`` (a module's name or an object's
        method) by ``wrapper`` for the run."""
        self._wrapped.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, wrapper)

    def restore(self):
        while self._wrapped:
            module, attr, real = self._wrapped.pop()
            setattr(module, attr, real)

    # ------------------------------------------------------------ spans

    def sync(self):
        """A synchronization of the harness's own, not counted as the
        program's."""
        if self.device.type != "cuda":
            return
        if self._counting:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        if self._counting:
            torch.cuda.set_sync_debug_mode("warn")

    @contextmanager
    def span(self, name):
        self.sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
            self.sync()
        self.spans.setdefault(name, []).append(
            (self.frame, time.perf_counter() - t0))

    # ----------------------------------------------------------- frames

    @contextmanager
    def frame_scope(self, frame, capture):
        """The program's work on one frame: sets the frame in flight and
        whether it is captured; in a traced run counts its host syncs."""
        self.frame, self.capturing = frame, capture
        caught = None
        try:
            if self.trace and self.count_syncs and \
                    self.device.type == "cuda":
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    torch.cuda.set_sync_debug_mode("warn")
                    self._counting = True
                    try:
                        yield
                    finally:
                        self._counting = False
                        torch.cuda.set_sync_debug_mode("default")
            else:
                yield
        finally:
            if caught is not None:
                self.syncs[frame] = sum("synchroniz" in str(w.message)
                                        for w in caught)
            self.frame, self.capturing = None, False

    def drop(self, frame):
        """Forget a frame's captures (it left the sample)."""
        self.captures.pop(frame, None)
