"""Flat gathers from a resident image on the card (counterpart of
``benchmarks/test_pallas_gather.py``):

    python -m tadataka_torch.probes.flat_gather

runs, at 480x640 with 64 index rows of 307200 (one sample set per pixel)
on the script's inputs from a seeded generator: the library's
``torch.take`` in place of the XLA line, ``flat_take`` (clip, one
gather per thread) and ``flat_take_rows`` (take_along_axis, eight index
rows a thread).  Each line gives the time in ms (CUDA-event median, L2
flushed) and whether the kernel is bit-equal to its plain version.  It
needs a CUDA device.
"""

import sys

import torch

from tadataka_torch.probes.exp_ssd import cuda_ms
from tadataka_torch.probes.gather import (
    flat_take, flat_take_reference, flat_take_rows, flat_take_rows_reference,
    same_bits)

SHAPE = (480, 640)
S = 64


def probe_inputs(shape=SHAPE, S=S, seed=0):
    """(img, idx) on the card: img uniform in [0, 1), idx (S, H*W) int32
    uniform in [0, H*W)."""
    H, W = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    img = torch.rand((H, W), generator=gen, device="cuda")
    idx = torch.randint(0, H * W, (S, H * W), generator=gen, device="cuda",
                        dtype=torch.int32)
    return img, idx


def run(shape=SHAPE, log=print):
    """Time and check both kernels and torch.take on the card; returns
    {"take": ms, "flat_take": {"ms", "correct"}, "flat_take_rows": ...}."""
    img, idx = probe_inputs(shape)
    flat, idx64 = img.reshape(-1), idx.long()     # torch.take wants int64
    results = {"take": cuda_ms(lambda: torch.take(flat, idx64))}
    log(f"torch.take (S,N)         : {results['take']:8.4f} ms")
    for label, fn, reference in (
            ("cuda flat_take          ", flat_take, flat_take_reference),
            ("cuda flat_take_rows     ", flat_take_rows,
             flat_take_rows_reference)):
        correct = same_bits(fn(img, idx), reference(img, idx))
        ms = cuda_ms(lambda: fn(img, idx))
        log(f"{label}: {ms:8.4f} ms   correct={correct}")
        results[fn.__name__] = dict(ms=ms, correct=correct)
    return results


def main():
    if not torch.cuda.is_available():
        print("flat_gather: needs a CUDA device", file=sys.stderr)
        sys.exit(2)
    print(torch.cuda.get_device_name(0), flush=True)
    results = run(log=lambda line: print(line, flush=True))
    if not all(r["correct"] for r in results.values()
               if isinstance(r, dict)):
        sys.exit(1)


if __name__ == "__main__":
    main()
