"""Flat gathers from a resident image on the card (counterpart of
``benchmarks/test_pallas_gather.py``):

    python -m tadataka_torch.probes.flat_gather

runs, at 480x640 with 64 index rows of 307200 (one sample set per pixel)
on the script's inputs from a seeded generator: the library's
``torch.take`` in place of the XLA line, ``flat_take`` (clip) and its
first kernel, one thread an element, timed in turns (medians and
quartiles of 20 rounds), then ``flat_take_rows`` (take_along_axis), also
on identity indices (idx[s, n] = n: the same bytes with no random
access, the gather's achievable floor) and on indices that share a
32-byte sector eight at a time (as random, with an eighth of the
distinct sectors).  Each line gives the time in ms
(CUDA-event median, L2 flushed) and whether the kernel is bit-equal to
its plain version.  It needs a CUDA device.
"""

import statistics
import sys

import torch

from tadataka_torch.probes.exp_ssd import cuda_ms, cuda_times
from tadataka_torch.probes.gather import (
    first_kernel, flat_take, flat_take_reference, flat_take_rows,
    flat_take_rows_reference, same_bits)

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


def identity_indices(S, N):
    """idx[s, n] = n, (S, N) int32 on the card."""
    return torch.arange(N, dtype=torch.int32, device="cuda").expand(
        S, N).contiguous()


def sector_indices(idx):
    """idx with each run of 8 columns gathering the 8 floats of one
    32-byte sector (the sector of the run's first index), in order."""
    n = torch.arange(idx.shape[1], device=idx.device)
    return (idx[:, n - n % 8] // 8 * 8 + (n % 8)).to(torch.int32)


def run(shape=SHAPE, log=print):
    """Time and check both kernels and torch.take on the card; returns
    {"take": ms (in turns with flat_take), "flat_take": {"ms",
    "quartiles", "correct"}, "flat_take/thread": ... (its first kernel),
    "flat_take_rows", "identity", "sector": {"ms", "correct"}
    (flat_take_rows on the probe's, identity and sector-sharing
    indices)}."""
    img, idx = probe_inputs(shape)
    flat, idx64 = img.reshape(-1), idx.long()     # torch.take wants int64
    plain = flat_take_reference(img, idx)
    fns = {"flat_take": lambda: flat_take(img, idx),
           "flat_take/thread": lambda: first_kernel(flat_take, img, idx)}
    correct = {name: same_bits(fn(), plain) for name, fn in fns.items()}
    fns["take"] = lambda: torch.take(flat, idx64)
    results = {}
    for name, ts in cuda_times(fns).items():
        q1, _, q3 = statistics.quantiles(ts, n=4)
        ms = statistics.median(ts)
        log(f"{name:36s}: {ms:8.4f} ms (quartiles {q1:.4f} - {q3:.4f}, in "
            "turns)" + (f"   correct={correct[name]}" if name in correct
                        else ""))
        results[name] = (ms if name == "take" else dict(
            ms=ms, quartiles=(q1, q3), correct=correct[name]))
    for key, label, index in (
            ("flat_take_rows", "cuda flat_take_rows", idx),
            ("identity", "cuda flat_take_rows, idx=n",
             identity_indices(*idx.shape)),
            ("sector", "cuda flat_take_rows, 8/sector",
             sector_indices(idx))):
        correct = same_bits(flat_take_rows(img, index),
                            flat_take_rows_reference(img, index))
        ms = cuda_ms(lambda: flat_take_rows(img, index))
        log(f"{label:36s}: {ms:8.4f} ms   correct={correct}")
        results[key] = dict(ms=ms, correct=correct)
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
