#!/usr/bin/env python3
"""The feature VO of this checkout against another checkout's, in turns
on one CUDA card: ms/frame and host synchronizations a frame.

    python3 tools/feature_turns.py OTHER_DIR [--rounds 2]

OTHER_DIR is an unpacked checkout of the repository (for example ``git
archive`` of a parent commit).  The frames are ``chip_smoke.py``'s
``feature`` cells (the EuRoC export at 480x752 and the multi-plane scene
at 480x640, each with its configuration and ``chip_smoke.fixed_draws``),
made once by this checkout.  Each round drives ``FeatureBasedVO`` over
each cell's frames with each tree, in the order other, this, this,
other, each tree's ``tadataka_torch`` modules alone in ``sys.modules``
while it runs: steady-state ms/frame (frames 2 on, the card synchronized
around each frame) and, in a last untimed run of each, the host
synchronizations of each frame (``torch.cuda.set_sync_debug_mode``).
It prints the median of each tree's rounds.  It needs a CUDA device.
"""

import argparse
import importlib
import statistics
import sys
import time
import warnings
from contextlib import contextmanager
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def _package_modules():
    return [k for k in sys.modules
            if k == "tadataka_torch" or k.startswith("tadataka_torch.")]


class Tree:
    """One checkout's tadataka_torch, imported with its modules kept apart
    from the other tree's."""

    def __init__(self, root):
        self.root = Path(root).resolve()
        self.modules = {}
        with self.active():
            importlib.import_module("tadataka_torch.vo.feature_based")

    @contextmanager
    def active(self):
        """This tree's modules in sys.modules (lazy imports inside the
        package resolve to them) and its root first on sys.path."""
        before = {k: sys.modules.pop(k) for k in _package_modules()}
        sys.modules.update(self.modules)
        sys.path.insert(0, str(self.root))
        try:
            yield
        finally:
            sys.path.remove(str(self.root))
            self.modules = {k: sys.modules.pop(k)
                            for k in _package_modules()}
            sys.modules.update(before)

    def drive(self, frames, vo_args, draws, count_syncs=False):
        """(ms of each frame, host syncs of each frame)."""
        with self.active():
            vo = self.modules["tadataka_torch.vo.feature_based"] \
                .FeatureBasedVO(device="cuda", rng=draws, **vo_args)
            ms, syncs = [], []
            for frame in frames:
                torch.cuda.synchronize()
                with warnings.catch_warnings(record=True) as caught:
                    if count_syncs:
                        warnings.simplefilter("always")
                        torch.cuda.set_sync_debug_mode("warn")
                    t0 = time.perf_counter()
                    assert vo.estimate(frame) is not None
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                    if count_syncs:
                        torch.cuda.set_sync_debug_mode("default")
                syncs.append(sum("synchroniz" in str(w.message)
                                 for w in caught))
        return ms, syncs


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("other", type=Path)
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("feature_turns: needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    trees = {"other": Tree(args.other), "this": Tree(ROOT)}
    for config in chip_smoke.FEATURE_CONFIGS:
        frames, _ = chip_smoke.feature_frames(config)
        vo_args = chip_smoke.FEATURE_CONFIGS[config]["vo"]
        for tree in trees.values():      # warm up each tree's first calls
            tree.drive(frames[:2], vo_args, chip_smoke.fixed_draws)
        steady = {name: [] for name in trees}
        for _ in range(args.rounds):
            for name in ("other", "this", "this", "other"):
                ms, _ = trees[name].drive(frames, vo_args,
                                          chip_smoke.fixed_draws)
                steady[name].append(statistics.mean(ms[2:]))
        for name, tree in trees.items():
            _, syncs = tree.drive(frames, vo_args, chip_smoke.fixed_draws,
                                  count_syncs=True)
            print(f"[turns] {config} {name} ({tree.root}): steady "
                  f"ms/frame median {statistics.median(steady[name]):.2f} "
                  f"of {', '.join(f'{m:.2f}' for m in steady[name])}; host "
                  f"syncs per frame {syncs}", flush=True)


if __name__ == "__main__":
    main()
