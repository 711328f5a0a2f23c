"""Structured per-frame metrics and profiling hooks (counterpart of
``tadataka_tpu/utils/observability.py``).

Per-frame metric records (pose, timing, flag histogram, inlier counts)
accumulate into a jsonl-serializable log (``SemiDenseVO(metrics=)``
takes a :class:`MetricsLogger`), and :func:`profile_trace` wraps
``torch.profiler``, writing a Chrome trace that holds the program's
spans (``utils/timing.py``) as user annotations.
"""

import contextlib
import json
import os
import time

import numpy as np
import torch

from tadataka_torch.flags import Flag, flag_histogram
from tadataka_torch.utils import timing


class MetricsLogger:
    def __init__(self, path=None):
        self.records = []
        self.path = path

    def log_frame(self, frame_index, **metrics):
        record = {"frame": int(frame_index), "t_wall": time.time()}
        for k, v in metrics.items():
            record[k] = _jsonable(v)
        self.records.append(record)
        if self.path is not None:
            with open(self.path, "a") as f:
                f.write(json.dumps(record) + "\n")
        return record

    def summary(self):
        """Mean of every numeric metric across frames."""
        keys = set().union(*(r.keys() for r in self.records)) \
            if self.records else set()
        out = {}
        for k in keys - {"frame", "t_wall"}:
            vals = [r[k] for r in self.records
                    if k in r and isinstance(r[k], (int, float))]
            if vals:
                out[k] = float(np.mean(vals))
        return out


def _jsonable(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().tolist()
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if hasattr(v, "tolist"):
        return np.asarray(v).tolist()
    return v


def flag_stats(flag_map):
    """Flag histogram as a {flag_name: count} dict."""
    hist = flag_histogram(flag_map).cpu().numpy()
    return {f.name: int(hist[-int(f)]) for f in Flag}


@contextlib.contextmanager
def profile_trace(logdir):
    """``torch.profiler`` over the block (CPU, and the card's kernels
    where there is one), with the program's spans traced unless a
    ``timing.trace()`` block is already open; writes ``trace.json``
    (Chrome trace format) into ``logdir`` and yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    spans = (contextlib.nullcontext() if timing.tracing()
             else timing.trace())
    with profile(activities=activities) as prof, spans:
        yield prof
    prof.export_chrome_trace(os.path.join(str(logdir), "trace.json"))


@contextlib.contextmanager
def timed(record, key):
    """Wall-time a block into record[key] (it waits for the card's queued
    work only if the caller synchronizes inside)."""
    t0 = time.perf_counter()
    yield
    record[key] = time.perf_counter() - t0
