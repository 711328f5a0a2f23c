"""Probes of the SSD window search on the card (counterpart of
``benchmarks/exp_ssd.py``): the V-read floor, the serial search's tile
sweep and the two-pass search with its error slab in shared memory.

    python -m tadataka_torch.probes.exp_ssd

runs them on the card at 480x640 on ``exp_ssd.py``'s inputs (uniform V
and K from a seeded generator, full window bounds) and prints each
time in ms, the floor's GB/s at S = 32, 48, 128 and 256 in every
variant beside ``torch.sum(V, 0)`` (also with a clean L2), and the
serial-against-par ``max|diff|`` lines.  It needs a CUDA device.

Each probe is a hand-written kernel (``csrc/ssd_probes.cu``) with a
plain PyTorch version beside it.  A wrapper launches its kernel on CUDA
tensors and counts the launch (``<wrapper>.launches``); on CPU tensors
it runs the plain version; anything else raises.
"""

import statistics
import sys
from pathlib import Path

import torch

from tadataka_torch.vo.semi_dense.estimator import EPSILON
from tadataka_torch.vo.semi_dense.sweep import (
    _INF, _check_ssd_inputs, ssd_search, ssd_search_reference)

SHAPE = (480, 640)
PLANES = (32, 48, 128, 256)
# the copy floor's variants: ("threads", pixels a thread, rows a block)
# and ("bulk", ring stages, blocks per SM)
COPY_VARIANTS = tuple(("threads", vec, rows) for vec in (1, 4)
                      for rows in (1, 8, 32)) + tuple(
    ("bulk", stages, ctas) for stages, ctas in ((2, 1), (4, 1), (8, 1),
                                                (8, 2)))
COPY_DEFAULT = ("bulk", 4, 1)
SERIAL_VARIANTS = tuple((cols, rows) for cols in (1, 2, 4)
                        for rows in (2, 8, 16))

_SOURCE = Path(__file__).parent / "csrc" / "ssd_probes.cu"
_library = None


def probe_library():
    """Build (at first use) and load the probe kernels."""
    global _library
    if _library is None:
        import ctypes
        from tadataka_torch.cuda_build import build
        built = build(_SOURCE)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        built.lib.ssd_copy_floor_launch.argtypes = [ptr] + [i32] * 5 + [
            ptr, ptr]
        built.lib.ssd_copy_floor_bulk_launch.argtypes = [ptr] + [i32] * 5 + [
            ptr, ptr]
        built.lib.ssd_serial_launch.argtypes = [ptr] * 4 + [i32] * 5 + [
            ptr] * 5
        built.lib.ssd_par_launch.argtypes = [ptr] * 4 + [i32] * 3 + [ptr] * 5
        built.lib.ssd_par_shared_bytes.argtypes = [i32]
        for fn in (built.lib.ssd_copy_floor_launch,
                   built.lib.ssd_copy_floor_bulk_launch,
                   built.lib.ssd_serial_launch, built.lib.ssd_par_launch,
                   built.lib.ssd_par_shared_bytes):
            fn.restype = i32
        _library = built
    return _library


def _device_of(name, *tensors):
    """'cpu' or 'cuda' for the wrapper ``name``; raises on any other
    device and, on the card, on non-contiguous or misaligned tensors."""
    device = tensors[0].device
    if device.type == "cpu":
        return "cpu"
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device}")
    for x in tensors:
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be contiguous and "
                             "16-byte aligned")
    return "cuda"


def _launch(name, status):
    if status != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                           f"{status}")


def _search_outputs(V):
    H, W = V.shape[1:]
    best = torch.empty((H, W), dtype=torch.int32, device=V.device)
    return (best,) + tuple(torch.empty((H, W), dtype=torch.float32,
                                       device=V.device) for _ in range(3))


# ---------------------------------------------------------- V-read floor

def ssd_copy_floor_reference(V):
    """Plain version: the S planes of V summed left to right."""
    acc = V[0]
    for s in range(1, V.shape[0]):
        acc = acc + V[s]
    return acc


def copy_variant_name(variant):
    """A copy-floor variant as the probe lines print it."""
    kind, a, b = variant
    if kind == "threads":
        return f"vec={a} rows={b:2d}"
    return f"bulk stages={a:2d} ctas/SM={b}"


def ssd_copy_floor(V, variant=COPY_DEFAULT):
    """Sum of the planes of V (S, H, W) float32, read once: the card's
    V-read floor.  ``variant`` is ("threads", vec, rows): ``vec`` 1 or 4
    pixels per thread (scalar or float4 loads), each block covering
    ``rows`` rows, which its threads walk (refuses W % vec != 0); or
    ("bulk", stages, ctas): ``ctas`` blocks per SM stream V through a
    ring of ``stages`` shared-memory stages with bulk copies (refuses
    H * W % 4 != 0)."""
    if V.dim() != 3 or V.dtype != torch.float32:
        raise ValueError("ssd_copy_floor wants V (S, H, W) float32")
    kind = variant[0]
    if kind not in ("threads", "bulk") or len(variant) != 3:
        raise ValueError(f"ssd_copy_floor: no variant {variant!r}")
    if _device_of("ssd_copy_floor", V) == "cpu":
        return ssd_copy_floor_reference(V)
    S, H, W = V.shape
    out = torch.empty((H, W), dtype=torch.float32, device=V.device)
    lib = probe_library().lib
    launch = (lib.ssd_copy_floor_launch if kind == "threads"
              else lib.ssd_copy_floor_bulk_launch)
    with torch.cuda.device(V.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch("ssd_copy_floor", launch(V.data_ptr(), S, H, W, *variant[1:],
                                         out.data_ptr(), stream))
    ssd_copy_floor.launches += 1
    return out


ssd_copy_floor.launches = 0


# --------------------------------------------------------- serial search

# The serial probe computes exactly what ssd_search computes.
ssd_serial_reference = ssd_search_reference


def ssd_serial(V, K, mlo, mhi, cols_per_thread=1, rows_per_block=8):
    """The serial SSD window search of ``ssd_search`` (same inputs and
    outputs, bit-equal) with ``cols_per_thread`` = 1, 2 or 4 adjacent
    columns per thread and blocks of 32 x ``rows_per_block`` threads."""
    _check_ssd_inputs(V, K, mlo, mhi)
    if _device_of("ssd_serial", V, K, mlo, mhi) == "cpu":
        return ssd_serial_reference(V, K, mlo, mhi)
    S, H, W = V.shape
    out = _search_outputs(V)
    with torch.cuda.device(V.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch("ssd_serial", probe_library().lib.ssd_serial_launch(
            V.data_ptr(), K.data_ptr(), mlo.data_ptr(), mhi.data_ptr(),
            S, H, W, cols_per_thread, rows_per_block,
            *(x.data_ptr() for x in out), stream))
    ssd_serial.launches += 1
    return out


ssd_serial.launches = 0


# ------------------------------------------------------- two-pass search

def ssd_par_reference(V, K, mlo, mhi):
    """Plain version of the two-pass search: every window's error in the
    rsqrt form err = 2 - 2 corr rsqrt(|w|^2 + eps) rsqrt(|K|^2 + eps),
    sums left to right, then the first window reaching the minimum and
    its neighbours' errors (3e38 outside the windows)."""
    M = V.shape[0] - 4
    w = [V[k:k + M] for k in range(5)]
    kk = K[0] * K[0]
    corr = w[0] * K[0]
    wn2 = w[0] * w[0]
    valid = w[0] >= 0.0
    for k in range(1, 5):
        kk = kk + K[k] * K[k]
        corr = corr + w[k] * K[k]
        wn2 = wn2 + w[k] * w[k]
        valid = valid & (w[k] >= 0.0)
    mf = torch.arange(M, dtype=V.dtype, device=V.device)[:, None, None]
    valid = valid & (mf >= mlo) & (mf <= mhi)
    err = 2.0 - 2.0 * corr * torch.rsqrt(wn2 + EPSILON) * torch.rsqrt(
        kk + EPSILON)
    errs = torch.where(valid, err, _INF)
    best = torch.argmin(errs, dim=0, keepdim=True)
    ec = torch.take_along_dim(errs, best, dim=0)[0]
    ep = torch.take_along_dim(errs, torch.clamp(best - 1, min=0), dim=0)[0]
    en = torch.take_along_dim(errs, torch.clamp(best + 1, max=M - 1),
                              dim=0)[0]
    best = best[0]
    ep = torch.where(best == 0, _INF, ep)
    en = torch.where(best == M - 1, _INF, en)
    return torch.where(ec >= _INF, -1, best).to(torch.int32), ec, ep, en


def ssd_par(V, K, mlo, mhi):
    """The two-pass SSD window search, its (M, 128-pixel) error slab in
    shared memory.  Same inputs and outputs as ``ssd_search``; the
    errors are in the rsqrt form of :func:`ssd_par_reference`.  Refuses
    an S whose slab does not fit in a block's shared memory."""
    _check_ssd_inputs(V, K, mlo, mhi)
    if _device_of("ssd_par", V, K, mlo, mhi) == "cpu":
        return ssd_par_reference(V, K, mlo, mhi)
    S, H, W = V.shape
    lib = probe_library().lib
    if lib.ssd_par_shared_bytes(S) == 0:
        raise ValueError(f"ssd_par: the error slab of S={S} does not fit "
                         "in a block's shared memory")
    out = _search_outputs(V)
    with torch.cuda.device(V.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch("ssd_par", lib.ssd_par_launch(
            V.data_ptr(), K.data_ptr(), mlo.data_ptr(), mhi.data_ptr(),
            S, H, W, *(x.data_ptr() for x in out), stream))
    ssd_par.launches += 1
    return out


ssd_par.launches = 0


# ----------------------------------------------------------- on the card

def _keep_busy(cycles=1 << 20):
    """Keep the card busy for ~0.5 ms before a timed call starts, so that
    the call's host-side work (argument checks, the launch) is done
    before the card reaches its start event and only device time is
    measured."""
    torch.cuda._sleep(cycles)


def cuda_ms(fn, repeats=20, flush_bytes=256 << 20, clean=False):
    """Median device ms of ``fn`` over ``repeats`` runs, each timed with
    CUDA events after the L2 cache is flushed by writing a larger
    buffer (the SSD volume is read cold on the main path).  That leaves
    L2 full of dirty lines, which a read must write back as it evicts
    them; ``clean`` flushes by reading the buffer instead.  The card is
    kept busy before each start event, so the host's part of the call
    is not timed."""
    flush = torch.empty(flush_bytes // 4, dtype=torch.float32, device="cuda")
    fn()
    times = []
    for _ in range(repeats):
        if clean:
            flush.sum()
        else:
            flush.zero_()
        _keep_busy()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cuda_times(fns, repeats=20, flush_bytes=256 << 20):
    """Device ms of each function of the dict ``fns``, ``repeats`` times,
    timed in turns: every round flushes L2 by writing a larger buffer
    before each call (as :func:`cuda_ms` does) and times every function
    once, so that a drift of the card's clock or power during the run
    reaches all of them alike.  Returns {name: [ms, ...]}."""
    flush = torch.empty(flush_bytes // 4, dtype=torch.float32, device="cuda")
    for fn in fns.values():
        fn()
    times = {name: [] for name in fns}
    for _ in range(repeats):
        for name, fn in fns.items():
            flush.zero_()
            _keep_busy()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return times


def probe_inputs(S, H, W, seed=0):
    """exp_ssd.py's inputs on the card: V (S, H, W) and K (5, H, W)
    uniform in [0, 1) from a seeded generator, every window allowed."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    V = torch.rand((S, H, W), generator=gen, device="cuda")
    K = torch.rand((5, H, W), generator=gen, device="cuda")
    mlo = torch.zeros((H, W), device="cuda")
    mhi = torch.full((H, W), float(S - 5), device="cuda")
    return V, K, mlo, mhi


def run_probes(planes=PLANES, shape=SHAPE, log=print):
    """Time every probe variant and ``torch.sum(V, 0)`` at each S on the
    card, and the sum, the float4 floor and the default bulk-copy floor
    again with a clean L2; returns {S: {"floor": {variant: ms}, "serial":
    {(cols, rows): ms}, "par": ms, "search": ms, "sum": ms, "clean":
    {"torch.sum", "threads", "bulk": ms}}} and logs one line per
    probe."""
    H, W = shape
    results = {}
    for S in planes:
        args = probe_inputs(S, H, W)
        gb = S * H * W * 4 / 1e6          # MB of V = GB/s at 1 ms
        floor = {v: cuda_ms(lambda v=v: ssd_copy_floor(args[0], v))
                 for v in COPY_VARIANTS}
        total = cuda_ms(lambda: torch.sum(args[0], 0))
        serial = {v: cuda_ms(lambda v=v: ssd_serial(*args, *v))
                  for v in SERIAL_VARIANTS}
        par = cuda_ms(lambda: ssd_par(*args))
        search = cuda_ms(lambda: ssd_search(*args))
        for v, ms in floor.items():
            log(f"S={S:3d} copy floor {copy_variant_name(v)}: {ms:.4f} ms, "
                f"{gb / ms:.1f} GB/s")
        log(f"S={S:3d} torch.sum(V, 0): {total:.4f} ms, {gb / total:.1f} "
            "GB/s")
        clean = {name: cuda_ms(fn, clean=True) for name, fn in (
            ("torch.sum", lambda: torch.sum(args[0], 0)),
            ("threads", lambda: ssd_copy_floor(args[0], ("threads", 4, 1))),
            ("bulk", lambda: ssd_copy_floor(args[0])))}
        log(f"S={S:3d} with a clean L2 (flushed by a read, no dirty line "
            "to write back): " + ", ".join(
                f"{name} {ms:.4f} ms ({gb / ms:.1f} GB/s)" for name, ms in zip(
                    ("torch.sum(V, 0)", "copy floor vec=4 rows= 1",
                     f"copy floor {copy_variant_name(COPY_DEFAULT)}"),
                    clean.values())))
        for (cols, rows), ms in serial.items():
            log(f"S={S:3d} serial cols={cols} rows={rows:2d}: {ms:.4f} ms, "
                f"{gb / ms:.1f} GB/s")
        log(f"S={S:3d} par (slab {(S - 4) * 512 / 1024:.1f} KB): "
            f"{par:.4f} ms, {gb / par:.1f} GB/s")
        log(f"S={S:3d} ssd_search: {search:.4f} ms, {gb / search:.1f} GB/s, "
            f"{min(floor.values()) / search:.3f} of the best floor")
        results[S] = dict(floor=floor, serial=serial, par=par, search=search,
                          sum=total, clean=clean)
    return results


def serial_vs_par(S=32, shape=SHAPE, log=print):
    """exp_ssd.py's cross-check: max |serial - par| of each output, and
    the share of pixels whose best window agrees (the two error forms
    round differently, so a near tie may pick another window)."""
    args = probe_inputs(S, *shape)
    serial, par = ssd_serial(*args), ssd_par(*args)
    diffs = {}
    for name, a, b in zip(("bm", "ec", "ep", "en"), serial, par):
        diffs[name] = (a.double() - b.double()).abs().max().item()
        log(f"{name} max|diff| {diffs[name]}")
    log(f"best equal on {(serial[0] == par[0]).double().mean().item():.6f}"
        " of pixels")
    return diffs


def main():
    if not torch.cuda.is_available():
        print("exp_ssd: needs a CUDA device", file=sys.stderr)
        sys.exit(2)
    print(torch.cuda.get_device_name(0), flush=True)
    run_probes(log=lambda line: print(line, flush=True))
    serial_vs_par()


if __name__ == "__main__":
    main()
