"""The shapes of ``ssd_search``'s ring kernel on the card, and the SSD
search's hard inputs.

    python -m tadataka_torch.probes.ssd_ring

builds ``csrc/ssd_search.cu`` once for every shape of ``RING_SHAPES``
(consumer threads, planes a stage, ring stages, blocks an SM at most:
the source's SSD_RING_* macros, all builds started together), times
each at 480x640 on random stacks of 48 planes with every window allowed
and on a rect plan's stack of 208 planes, beside the package's own
build, checks each launch bit-equal to the plain version, and prints
each shape's launch plan (tile size, grid, shared memory).  It needs a CUDA device.  The launches go through the
launchers directly, so ``ssd_search.launches`` does not count them.
"""

import statistics
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from tadataka_torch.probes.exp_ssd import cuda_times, probe_inputs
from tadataka_torch.vo.semi_dense.sweep import (
    _SSD_SOURCE, _launch, bind_ssd_library, ring_config, ssd_library,
    ssd_search_reference)

SHAPE = (480, 640)
RING_SHAPES = (
    (256, 16, 4, 2), (256, 16, 2, 2), (256, 16, 8, 2), (256, 16, 4, 1),
    (256, 8, 4, 2), (256, 8, 8, 2), (128, 16, 4, 4), (128, 16, 8, 4),
    (128, 16, 4, 3))
_MACROS = ("SSD_RING_CONSUMERS", "SSD_RING_ROWS", "SSD_RING_STAGES",
           "SSD_RING_CTAS")


def shape_libraries(shapes=RING_SHAPES):
    """{shape: the search library built with that ring shape}, the
    builds run in parallel."""
    from tadataka_torch.cuda_build import build

    def build_shape(shape):
        return bind_ssd_library(build(_SSD_SOURCE, tuple(zip(_MACROS, shape))))

    with ThreadPoolExecutor(len(shapes)) as pool:
        return dict(zip(shapes, pool.map(build_shape, shapes)))


def ssd_inputs(S, H, W, seed):
    """Random plane volume with ~20% invalid lanes, all-invalid rows,
    narrow window ranges on half the pixels, a planted key patch and
    exact planted ties, on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    M = S - 4
    V = torch.rand((S, H, W), generator=gen, device=dev)
    V[torch.rand((S, H, W), generator=gen, device=dev) < 0.2] = -1.0
    K = torch.rand((5, H, W), generator=gen, device=dev)
    V[6:11, :, : W // 4] = K[:, :, : W // 4]           # planted at m = 6
    V[S - 5:, :, : W // 8] = K[:, :, : W // 8]         # ... and tied at M-1
    V[:, :3] = -1.0                                    # all-invalid pixels
    mlo = torch.zeros((H, W), device=dev)
    mhi = torch.full((H, W), float(M - 1), device=dev)
    narrow = torch.rand((H, W), generator=gen, device=dev) < 0.5
    lo = torch.randint(0, M, (H, W), generator=gen, device=dev).float()
    width = torch.randint(0, 5, (H, W), generator=gen, device=dev).float()
    mlo = torch.where(narrow, lo, mlo)
    mhi = torch.where(narrow, lo + width, mhi)
    return V, K, mlo, mhi


def nan_inputs(S, H, W, seed):
    """:func:`ssd_inputs` (S >= 16, H >= 64) with window errors that are
    NaN, on the card, each kind on its own band of rows: one NaN key
    sample on a tenth of the pixels (rows 0-7), a whole NaN key (8-15),
    an infinite sample at a tenth of the (plane, pixel) pairs (16-23),
    plane 11 infinite, so that window 7 after the best at the planted
    window 6 is NaN (24-31), plane 0 infinite with every window allowed
    (32-39: window 0 NaN, no best), bounds from window 3 and plane 3
    infinite (40-47: the first window in bounds NaN), samples and keys
    of 1e20 (48-55: squares and products overflow) and samples of 1e19
    with keys of -1e20 (56-63: 2 corr overflows to -inf)."""
    V, K, mlo, mhi = ssd_inputs(S, H, W, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    dev = "cuda"
    inf = float("inf")
    some = torch.rand((H, W), generator=gen, device=dev) < 0.1
    k = torch.randint(0, 5, (H, W), generator=gen, device=dev)
    hit = some & (torch.arange(H, device=dev)[:, None] < 8)
    K[k[hit], hit.nonzero()[:, 0], hit.nonzero()[:, 1]] = float("nan")
    K[:, 8:16] = float("nan")
    band = V[:, 16:24]
    band[torch.rand(band.shape, generator=gen, device=dev) < 0.1] = inf
    V[6:11, 24:32] = K[:, 24:32]
    V[11, 24:32] = inf
    mlo[24:48], mhi[24:48] = 0.0, float(S - 5)
    V[0, 32:40] = inf
    mlo[40:48] = 3.0
    V[3, 40:48] = inf
    V[:, 48:56] = 1e20
    K[:, 48:56] = 1e20
    V[:, 56:64] = 1e19
    K[:, 56:64] = -1e20
    return V, K, mlo, mhi


def rect_inputs(S, H, W, seed):
    """A rect-plan-shaped search on the card: V is ``_shift_stack`` of one
    image shifted by a fractional disparity (-1 fill columns), K the key
    template of that image at another disparity, and pixels whose
    template leaves the image, plus a tenth of the others, get the
    sentinel bounds mlo = 1e9 / mhi = -1e9 (sweep_rect.py:151-153); the
    others search 17 windows around a random centre."""
    from tadataka_torch.core.shiftwarp import const_shift_cols
    from tadataka_torch.vo.semi_dense.sweep_rect import (
        _key_template, _shift_stack)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    image = torch.rand((H, W), generator=gen, device="cuda")
    base = const_shift_cols(image, torch.tensor(-7.25, device="cuda"))
    V = _shift_stack(base, S, fill=-1.0)
    K = _key_template(const_shift_cols(image, torch.tensor(
        -float(S // 3), device="cuda")))
    M = S - 4
    lo = torch.randint(0, M, (H, W), generator=gen, device="cuda").float()
    mlo, mhi = lo - 8.0, lo + 8.0
    off = (torch.rand((H, W), generator=gen, device="cuda") < 0.1) \
        | ~torch.all(K >= 0.0, dim=0)
    mlo = torch.where(off, 1e9, mlo)
    mhi = torch.where(off, -1e9, mhi)
    return V, K, mlo, mhi


def run(shape=SHAPE, log=print):
    """Time the ring in every shape of RING_SHAPES and the package's build
    ("default") on the two inputs, in turns (``cuda_times``: a drift of
    the card reaches all alike); returns {case: {name: median ms}} and
    raises if a launch is not bit-equal to the plain version or a build
    has another shape than asked."""
    H, W = shape
    libraries = shape_libraries()
    libraries["default"] = ssd_library()
    cases = {"random S=48": probe_inputs(48, H, W),
             "rect S=208": rect_inputs(208, H, W, seed=208)}
    results = {}
    for name, args in cases.items():
        S = args[0].shape[0]
        plain = ssd_search_reference(*args)
        plans = {k: ring_config(S, H, W, lib) for k, lib in libraries.items()}
        for k, plan in plans.items():
            assert k == "default" or plan["shape"] == k, (k, plan)
            out = _launch(*args, library=libraries[k])
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(out, plain)):
                raise AssertionError(f"ring {k} differs from the plain "
                                     f"version on {name}")
        times = cuda_times({k: lambda lib=lib: _launch(*args, library=lib)
                            for k, lib in libraries.items()})
        ms = {k: statistics.median(v) for k, v in times.items()}
        for k, plan in plans.items():
            q1, q3 = statistics.quantiles(times[k], n=4)[::2]
            log(f"{name} ring {plan['shape']}"
                f"{' (default)' if k == 'default' else ''}: {ms[k]:.4f} ms "
                f"(quartiles {q1:.4f}-{q3:.4f}); "
                f"tile {plan['tile']} px, {plan['tiles']} tiles on a grid of "
                f"{plan['grid']} ({plan['blocks_per_sm']} an SM, "
                f"{plan['threads']} threads, {plan['shared_bytes']} B "
                "shared); bit-equal to plain")
        best = min(RING_SHAPES, key=ms.get)
        log(f"{name}: fastest ring shape {best} {ms[best]:.4f} ms; the "
            f"default {plans['default']['shape']} {ms['default']:.4f} ms")
        results[name] = ms
    return results


def main():
    if not torch.cuda.is_available():
        print("ssd_ring: needs a CUDA device", file=sys.stderr)
        sys.exit(2)
    print(torch.cuda.get_device_name(0), flush=True)
    run(log=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main()
