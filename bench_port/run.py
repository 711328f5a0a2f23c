#!/usr/bin/env python3
"""The benchmark of tadataka_torch: one run of one cell.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  Loads the cell's configuration and
traffic mix (``BENCHMARK.json``), renders the loop's frames from the
seed, builds the app, warms up over the app's first frames, measures
for ``--seconds`` (``--trace 1``: the per-layer metrics, with spans,
counters and a profiled stretch of frames), checks the frames it
sampled against the plain reference, and prints one JSON line last on
standard output.  Without a CUDA card it exits non-zero and prints no
result.  The kernel library builds into ``build/tadataka_torch/``
inside the checkout, so only a checkout's first run compiles.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    # a library that would load JAX by itself is kept from it
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")

    sys.path.insert(0, str(ROOT))
    import tadataka_torch  # noqa: F401  (the system under test)
    import torch
    from bench_port.harness import drive, spec
    bench = spec.load_benchmark(ROOT)
    entry, _ = spec.cell(bench, args.workload)
    chips = int(entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench_port: {args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found; nothing was run",
              file=sys.stderr)
        return 2
    result = drive.run(args.workload, args.seed, args.seconds,
                       bool(args.trace), device="cuda", t_start=T_START,
                       root=ROOT)
    return 0 if result is not None else 1


if __name__ == "__main__":
    sys.exit(main())
