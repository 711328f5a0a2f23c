#!/usr/bin/env python3
"""The readings that a cell's limits are set from, in one process.

    python3 bench_port/calibrate.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--out chiprun_out/calibrate.jsonl]

For each seed, one run of the cell as ``run.py`` makes it (set-up,
warm-up, a window of ``--seconds``, the check of the sampled frames),
and then the control on the same captures: the reference held in
bfloat16, judged against the reference.  Prints, and appends to
``--out``, one JSON line a seed with the program's and the control's
numbers.  The benchmark's own runs never run the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from bench_port.harness import drive
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card; nothing was run", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = drive.run(args.workload, seed, args.seconds, False,
                      device="cuda", root=ROOT, control=True,
                      out=sys.stderr)
        line = {"workload": args.workload, "seed": seed,
                "frames": r["attempted"], "failed": r["failed"],
                "program": {k: v["value"] for k, v in r["checks"].items()},
                "control": r["control"],
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
