"""Gather probes along an image axis on the card (counterpart of
``benchmarks/test_dynamic_gather.py``):

    python -m tadataka_torch.probes.dynamic_gather

runs, at 480x640 on the script's inputs (a uniform image and uniform
row / column indices from a seeded generator): ``take_along_axis`` along
rows and along columns, the library's ``torch.gather`` in place of the
XLA lines, and 16 fused two-pass index warps.  Each line gives the
kernel's time in us (CUDA-event median, L2 flushed) and whether it is
bit-equal to its plain version.  It needs a CUDA device.
"""

import sys

import torch

from tadataka_torch.probes.exp_ssd import cuda_ms
from tadataka_torch.probes.gather import (
    multi_warp, multi_warp_reference, same_bits, take_along_axis0,
    take_along_axis1, take_along_axis_reference)

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


def run(shape=SHAPE, log=print):
    """Time and check the three kernels and torch.gather on the card;
    returns {name: {"ms", "correct"}} for take_along_axis0,
    take_along_axis1, multi_warp, and {"gather0", "gather1": ms}."""
    img, rows, cols = probe_inputs(shape)
    results = {}
    for label, fn, idx, axis in (("axis=0 (rows)", take_along_axis0, rows, 0),
                                 ("axis=1 (cols)", take_along_axis1, cols,
                                  1)):
        correct = same_bits(fn(img, idx),
                            take_along_axis_reference(img, idx, axis))
        ms = cuda_ms(lambda: fn(img, idx))
        log(f"cuda take_along_axis {label}: {ms * 1e3:9.1f} us  "
            f"correct={correct}")
        results[fn.__name__] = dict(ms=ms, correct=correct)
    for axis, idx in ((0, rows), (1, cols)):
        ms = cuda_ms(lambda: torch.gather(img, axis, idx))
        log(f"torch.gather axis={axis}: {ms * 1e3:9.1f} us")
        results[f"gather{axis}"] = ms
    correct = same_bits(multi_warp(img, rows, cols, S),
                        multi_warp_reference(img, rows, cols, S))
    ms = cuda_ms(lambda: multi_warp(img, rows, cols, S))
    log(f"cuda {S}x(2-pass warp)     : {ms * 1e3:9.1f} us  "
        f"({ms / S * 1e3:6.1f} us/warp)  correct={correct}")
    results["multi_warp"] = dict(ms=ms, correct=correct)
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
