"""Gather probes along an image axis on the card (counterpart of
``benchmarks/test_dynamic_gather.py``):

    python -m tadataka_torch.probes.dynamic_gather

runs, at 480x640 on the script's inputs (a uniform image and uniform
row / column indices from a seeded generator): ``take_along_axis`` along
rows and along columns (with its first kernel, one thread an element),
the library's ``torch.gather`` in place of the XLA lines, 16 fused
two-pass index warps, and an empty kernel, the card's floor for one
launch.  Each
line gives the time in us (CUDA-event median and quartiles of 20
rounds, L2 flushed, every function timed once a round in turns) and
whether the kernel is bit-equal to its plain version.  It needs a CUDA
device.
"""

import statistics
import sys

import torch

from tadataka_torch.probes.exp_ssd import cuda_times
from tadataka_torch.probes.gather import (
    empty_launch, first_kernel, multi_warp, multi_warp_reference, same_bits,
    take_along_axis0, take_along_axis1, take_along_axis_reference)

SHAPE = (480, 640)
S = 16


def probe_inputs(shape=SHAPE, seed=0):
    """(img, idx_rows, idx_cols) on the card: img uniform in [0, 1),
    row indices in [0, H), column indices in [0, W), int32."""
    H, W = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    img = torch.rand((H, W), generator=gen, device="cuda")
    rows = torch.randint(0, H, (H, W), generator=gen, device="cuda",
                         dtype=torch.int32)
    cols = torch.randint(0, W, (H, W), generator=gen, device="cuda",
                         dtype=torch.int32)
    return img, rows, cols


def kernels(img, rows, cols):
    """{name: (call, plain version's call)} of every kernel the probe
    times; "take_along_axis1/thread" is take_along_axis1's first
    kernel."""
    return {
        "take_along_axis0": (
            lambda: take_along_axis0(img, rows),
            lambda: take_along_axis_reference(img, rows, 0)),
        "take_along_axis1": (
            lambda: take_along_axis1(img, cols),
            lambda: take_along_axis_reference(img, cols, 1)),
        "take_along_axis1/thread": (
            lambda: first_kernel(take_along_axis1, img, cols),
            lambda: take_along_axis_reference(img, cols, 1)),
        "multi_warp": (
            lambda: multi_warp(img, rows, cols, S),
            lambda: multi_warp_reference(img, rows, cols, S))}


def run(shape=SHAPE, log=print, repeats=20):
    """Check every kernel on the card, then time them, both
    ``torch.gather`` calls and the empty launch in turns; returns
    {name: {"ms", "quartiles", "correct"}} for each name of
    :func:`kernels`, and {"gather0", "gather1", "launch_floor": ms}."""
    img, rows, cols = probe_inputs(shape)
    calls = kernels(img, rows, cols)
    correct = {name: same_bits(fn(), plain())
               for name, (fn, plain) in calls.items()}
    fns = {name: fn for name, (fn, _) in calls.items()}
    fns["gather0"] = lambda: torch.gather(img, 0, rows)
    fns["gather1"] = lambda: torch.gather(img, 1, cols)
    fns["launch_floor"] = empty_launch
    times = cuda_times(fns, repeats=repeats)
    results = {}
    for name, ts in times.items():
        q1, median, q3 = statistics.quantiles(ts, n=4)
        label = name + (f" ({S} two-pass warps)"
                        if name.startswith("multi_warp") else "")
        log(f"{label:36s}: {statistics.median(ts) * 1e3:8.2f} us  "
            f"(quartiles {q1 * 1e3:.2f} - {q3 * 1e3:.2f})"
            + (f"  correct={correct[name]}" if name in correct else ""))
        if name in correct:
            results[name] = dict(ms=statistics.median(ts),
                                 quartiles=(q1, q3), correct=correct[name])
        else:
            results[name] = statistics.median(ts)
    return results


def main():
    if not torch.cuda.is_available():
        print("dynamic_gather: needs a CUDA device", file=sys.stderr)
        sys.exit(2)
    print(torch.cuda.get_device_name(0), flush=True)
    results = run(log=lambda line: print(line, flush=True))
    if not all(r["correct"] for r in results.values()
               if isinstance(r, dict)):
        sys.exit(1)


if __name__ == "__main__":
    main()
