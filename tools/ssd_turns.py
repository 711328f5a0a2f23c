#!/usr/bin/env python3
"""The SSD search kernels of this checkout against another checkout's,
timed in turns on one CUDA card.

    python3 tools/ssd_turns.py OTHER_DIR [--rounds 20]

OTHER_DIR is an unpacked checkout of the repository (for example ``git
archive`` of a parent commit).  The script imports each tree's own
``tadataka_torch`` (its ``sweep`` and ``probes.exp_ssd`` modules, one
tree's modules at a time in ``sys.modules``), builds each tree's two SSD
libraries through its own loaders (``ssd_library``, ``probe_library``),
prints each build's ptxas registers and spills of the search kernels,
checks that both trees give the same bits on NaN-free inputs at
480x640, and times every design of ``ssd_search`` ("ring", "thread") at
S = 48 on ``ssd_inputs`` and of the probes (``ssd_serial`` "thread" and
"tile", ``ssd_par`` "slab" and "tile") at S = 32 on ``probe_inputs``,
each through its tree's public wrapper: each kernel of both trees once
a round, in the order other, this, this, other (``cuda_times``, L2
flushed by a write before each call).  It prints the median and
quartiles of each.  It needs a CUDA device.
"""

import argparse
import importlib
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
KERNELS = ("ssd_search_ring_kernel", "ssd_search_kernel", "serial_kernelILi1",
           "tile_kernelILb1", "tile_kernelILb0", "par_kernel")


def _package_modules():
    return [k for k in sys.modules
            if k == "tadataka_torch" or k.startswith("tadataka_torch.")]


def load_tree(root):
    """Import ``root``'s tadataka_torch and build its SSD libraries while
    its modules alone are loaded, then put back the modules that were
    loaded before; returns its (sweep, exp_ssd) modules and builds."""
    before = {k: sys.modules.pop(k) for k in _package_modules()}
    sys.path.insert(0, str(root))
    try:
        sweep = importlib.import_module("tadataka_torch.vo.semi_dense.sweep")
        probes = importlib.import_module("tadataka_torch.probes.exp_ssd")
        with ThreadPoolExecutor(2) as pool:
            built = list(pool.map(lambda load: load(),
                                  (sweep.ssd_library, probes.probe_library)))
    finally:
        sys.path.remove(str(root))
        for k in _package_modules():
            del sys.modules[k]
        sys.modules.update(before)
    return sweep, probes, built


def calls(sweep, probes, search_args, probe_args):
    """{design: function} calling one tree's wrapper of each kernel."""
    return {
        "ssd_search ring": lambda: sweep.ssd_search(*search_args,
                                                    design="ring"),
        "ssd_search thread": lambda: sweep.ssd_search(*search_args,
                                                      design="thread"),
        "ssd_serial thread": lambda: probes.ssd_serial(*probe_args,
                                                       design="thread"),
        "ssd_serial tile": lambda: probes.ssd_serial(*probe_args,
                                                     design="tile"),
        "ssd_par slab": lambda: probes.ssd_par(*probe_args, design="slab"),
        "ssd_par tile": lambda: probes.ssd_par(*probe_args, design="tile")}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("other", type=Path)
    parser.add_argument("--rounds", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("ssd_turns: needs a CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(ROOT))
    from tadataka_torch.probes.exp_ssd import cuda_times, probe_inputs
    from tadataka_torch.probes.ssd_ring import ssd_inputs
    print(torch.cuda.get_device_name(0), flush=True)
    search_args = ssd_inputs(48, 480, 640, seed=48)
    probe_args = probe_inputs(32, 480, 640)
    fns = {}
    for tree, root in (("other", args.other.resolve()), ("this", ROOT)):
        sweep, probes, built = load_tree(root)
        for lib in built:
            lines = lib.log.splitlines()
            for i, line in enumerate(lines):
                kernel = next((k for k in KERNELS if k in line), None)
                if "Compiling entry function" in line and kernel:
                    usage = " ".join(x.strip() for x in lines[i + 2:i + 4])
                    print(f"{tree} {lib.path.name} {kernel}: {usage}",
                          flush=True)
        fns[tree] = calls(sweep, probes, search_args, probe_args)
    for design in fns["this"]:
        a, b = fns["other"][design](), fns["this"][design]()
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"{design}: the two trees differ")
    order = {}
    for design in fns["this"]:
        order[f"{design} other"] = fns["other"][design]
        order[f"{design} this"] = fns["this"][design]
        order[f"{design} this again"] = fns["this"][design]
        order[f"{design} other again"] = fns["other"][design]
    times = cuda_times(order, repeats=args.rounds)
    for design in fns["this"]:
        line = []
        for who in ("other", "this"):
            ts = times[f"{design} {who}"] + times[f"{design} {who} again"]
            q1, _, q3 = statistics.quantiles(ts, n=4)
            line.append(f"{who} {statistics.median(ts):.4f} ms ({q1:.4f}-"
                        f"{q3:.4f})")
        print(f"{design}: " + ", ".join(line) + "; bit-equal", flush=True)


if __name__ == "__main__":
    main()
