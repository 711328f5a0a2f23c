"""Probes of the SSD window search on the card (counterpart of
``benchmarks/exp_ssd.py``): the V-read floor, the serial search and the
two-pass search, each search with two kernels that its wrapper picks
from the input ("tile", else "thread" for ``ssd_serial``; "tile", else
"slab" for ``ssd_par``).

    python -m tadataka_torch.probes.exp_ssd

runs them on the card at 480x640 on ``exp_ssd.py``'s inputs (uniform V
and K from a seeded generator, full window bounds) and prints each
time in ms, the floor's GB/s at S = 32, 48, 128 and 256 in every
variant beside ``torch.sum(V, 0)`` (also with a clean L2), the serial
"thread" kernel's block shapes where it runs, both searches and
``ssd_search`` timed in turns, the re-score counts of ``ssd_serial``
"tile", and the serial-against-par ``max|diff|`` lines.  It needs a
CUDA device.

Each probe is a hand-written kernel (``csrc/ssd_probes.cu``) with a
plain PyTorch version beside it.  A wrapper launches its kernel on CUDA
tensors and counts the launch (``<wrapper>.launches``); on CPU tensors
it runs the plain version; anything else raises.
"""

import statistics
import sys
from pathlib import Path

import numpy as np
import torch

from tadataka_torch.core.rounding import sqrt
from tadataka_torch.vo.semi_dense.estimator import EPSILON
from tadataka_torch.vo.semi_dense.sweep import (
    _INF, _check_ssd_inputs, _serial_scan, _take, _window_errors, ssd_search,
    ssd_search_reference, ssd_window_bounds)

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
# ssd_serial runs "tile" up to SERIAL_TILE_MAX_S planes and "thread"
# above (serial_design), the faster of the two there on the probe inputs
# at 480x640 on the card (PERF.md); ssd_par runs "tile", the faster of
# its two at every S measured, wherever it takes the input
SERIAL_TILE_MAX_S = 128
# |a - e| <= FILTER_DELTA for the "tile" serial search's approximate error
# a of every window it certifies (the bound is derived in
# csrc/ssd_probes.cu, kFilterDelta)
FILTER_DELTA = 2.0 ** -17

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
        lib = built.lib
        lib.ssd_copy_floor_launch.argtypes = [ptr] + [i32] * 5 + [ptr, ptr]
        lib.ssd_copy_floor_bulk_launch.argtypes = [ptr] + [i32] * 5 + [
            ptr, ptr]
        lib.ssd_serial_launch.argtypes = [ptr] * 4 + [i32] * 5 + [ptr] * 5
        lib.ssd_par_launch.argtypes = [ptr] * 4 + [i32] * 3 + [ptr] * 5
        lib.ssd_par_shared_bytes.argtypes = [i32]
        lib.ssd_tile_config.argtypes = [i32] * 4 + [ptr]
        lib.ssd_serial_tile_launch.argtypes = [ptr] * 4 + [i32] * 3 + [
            ptr] * 6
        lib.ssd_par_tile_launch.argtypes = [ptr] * 4 + [i32] * 3 + [ptr] * 5
        for fn in (lib.ssd_copy_floor_launch, lib.ssd_copy_floor_bulk_launch,
                   lib.ssd_serial_launch, lib.ssd_par_launch,
                   lib.ssd_par_shared_bytes, lib.ssd_tile_config,
                   lib.ssd_serial_tile_launch, lib.ssd_par_tile_launch):
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

_FLOAT_MAX = torch.finfo(torch.float32).max


def filter_approx_errors(V, K, rho=0.0):
    """Pass 1 of ssd_serial "tile" in plain PyTorch: the approximate
    error of every window (M, H, W), a = 2 - fl(corr * fl(2 / kn)) * r
    with one rounding (a fused multiply-add), corr a fused sum (each
    product added with one rounding) and r = rsqrt(wn2) (1 + rho), a
    stand-in for the card's rsqrt.approx, rounded once; wn2 and kn are
    the exact search's.  Returns (a, wn2, kn)."""
    M = V.shape[0] - 4
    w = [V[k:k + M] for k in range(5)]
    kk = K[0] * K[0]
    wn2 = w[0] * w[0]
    corr = w[0] * K[0]
    for k in range(1, 5):
        kk = kk + K[k] * K[k]
        wn2 = wn2 + w[k] * w[k]
        corr = (w[k].double() * K[k].double() + corr.double()).float()
    kn = sqrt(kk) + EPSILON
    r = (torch.rsqrt(wn2.double()) * (1.0 + rho)).float()
    x = corr * (torch.full_like(kn, 2.0) / kn)
    return (2.0 - x.double() * r.double()).float(), wn2, kn


def _filter(V, K, mlo, mhi, approx):
    """The plain filter's state: exact errors, window range, validity,
    the certified pixels and each window's candidacy."""
    S = V.shape[0]
    M = S - 4
    a, wn2, kn = filter_approx_errors(V, K)
    if approx is not None:
        a = approx
    lo, hi = (x.long() for x in ssd_window_bounds(mlo, mhi, S))
    m = torch.arange(M, device=V.device)[:, None, None]
    nonneg = V >= 0.0
    valid = (m >= lo) & (m <= hi)
    for k in range(5):
        valid = valid & nonneg[k:k + M]
    tk = torch.full_like(kn, 2.0 ** -28) / kn
    window_ok = (wn2 > tk * tk) & (wn2 >= 2.0 ** -126) & (wn2 <= _FLOAT_MAX)
    trusted = (kn >= 2.0 ** -60) & (kn <= 2.0 ** 60) & ~(
        valid & ~window_ok).any(0)
    ranked = torch.where(valid, a, _FLOAT_MAX)
    cutoff = ranked.min(0).values + torch.tensor(3.0 * FILTER_DELTA)
    return dict(errs=_window_errors(V, K, mlo, mhi), lo=lo, hi=hi,
                valid=valid, scan=(lo <= hi) & ~trusted,
                certified=trusted & valid.any(0),
                candidate=valid & (ranked <= cutoff))


def ssd_serial_filter_reference(V, K, mlo, mhi, approx=None):
    """Plain version of ssd_serial "tile": the candidate filter.  ``approx``
    (M, H, W) replaces the approximate errors of
    :func:`filter_approx_errors`; the outputs are ssd_search's exact ones
    wherever |approx - exact| <= FILTER_DELTA on every window.

    A pixel is certified where its kn lies in [2^-60, 2^60] and every
    window in its bounds with valid samples has a normal wn2 above
    (2^-28 / kn)^2.  A certified pixel's candidates are its valid
    windows whose approximate error is at most the least one plus 3
    FILTER_DELTA; it takes the first exact minimum among them and its
    neighbours' exact errors.  Any other pixel runs the serial scan over
    the exact errors.  Returns ((best, ec, ep, en), (windows scored
    exactly, pixels that ran the whole exact scan, certified pixels with
    more than one candidate))."""
    f = _filter(V, K, mlo, mhi, approx)
    errs, lo, hi, ok = f["errs"], f["lo"], f["hi"], f["certified"]
    M = errs.shape[0]
    b = torch.argmin(torch.where(f["candidate"], errs, np.inf), dim=0)
    best, ec, ep, en = _serial_scan(errs)
    out = (torch.where(ok, b.to(torch.int32), best),
           torch.where(ok, _take(errs, b), ec),
           torch.where(ok, torch.where(
               b > lo, _take(errs, torch.clamp(b - 1, min=0)), _INF), ep),
           torch.where(ok, torch.where(
               b < hi, _take(errs, torch.clamp(b + 1, max=M - 1)), _INF),
               en))
    n_candidates = f["candidate"].sum(0)
    scan = f["scan"]
    n_exact = torch.where(ok, n_candidates + (b > lo).long()
                          + (b < hi).long(), 0) + torch.where(
        scan, hi - lo + 1, 0)
    return out, (int(n_exact.sum()), int(scan.sum()),
                 int((ok & (n_candidates > 1)).sum()))


def filter_census(V, K, mlo, mhi):
    """Why the plain filter of ssd_serial "tile" re-scores what it does,
    in pixel counts: "windows" (a window in bounds), "scan" (the exact
    scan: a key norm or a valid window's wn2 out of the certified
    ranges), "one" (one candidate), "several" (two
    candidates or more; "candidates": their mean count), and "exact_tie"
    (the two least exact errors of a pixel are equal)."""
    f = _filter(V, K, mlo, mhi, None)
    live = f["lo"] <= f["hi"]
    n = f["candidate"].sum(0)
    ok = f["certified"]
    two = torch.topk(torch.where(f["valid"], f["errs"], np.inf),
                     min(2, f["errs"].shape[0]), dim=0, largest=False).values
    tie = f["valid"].sum(0) > 1
    if two.shape[0] > 1:
        tie = tie & (two[0] == two[1])
    several = ok & (n > 1)
    return dict(windows=int(live.sum()), scan=int(f["scan"].sum()),
                one=int((ok & (n == 1)).sum()), several=int(several.sum()),
                candidates=float(n[several].float().mean()) if several.any()
                else 0.0, exact_tie=int(tie.sum()))


def tile_config(S, H, W, serial):
    """The "tile" plan of ``ssd_serial`` (``serial`` True) or ``ssd_par``
    at S planes and H x W on the current card: a dict of P (pixels a
    tile), tiles, grid, threads a block, shared bytes a block, blocks an
    SM, chunks of V a tile (a TMA box and an mbarrier each) and planes a
    chunk.  Raises ValueError where
    "tile" refuses the shape: H * W % 4 != 0 (a TMA box reads rows of
    whole 16-byte vectors), or two tiles of S planes that do not fit in
    a block's shared memory even at P = 32 (S > 896)."""
    import ctypes
    name = "ssd_serial" if serial else "ssd_par"
    if H * W % 4:
        raise ValueError(f'{name} "tile" needs H * W % 4 == 0 (its TMA boxes '
                         f"read whole 16-byte vectors), got {H}x{W}")
    out = (ctypes.c_int * 8)()
    lib = probe_library().lib
    if lib.ssd_tile_config(S, H, W, int(serial), out) != 0:
        raise ValueError(f'{name} "tile": two tiles of S={S} planes do not '
                         "fit in a block's shared memory")
    return dict(zip(("tile", "tiles", "grid", "threads", "shared_bytes",
                     "blocks_per_sm", "chunks", "chunk_rows"), out))


def serial_design(S):
    """ssd_serial's kernel at S planes where "tile" takes the shape."""
    return "tile" if S <= SERIAL_TILE_MAX_S else "thread"


def ssd_serial(V, K, mlo, mhi, cols_per_thread=1, rows_per_block=8,
               rescore=None):
    """The serial SSD window search of ``ssd_search`` (same inputs and
    outputs, bit-equal), by one of two kernels:

    - "tile", at S <= SERIAL_TILE_MAX_S planes (:func:`serial_design`)
      where H * W % 4 == 0: the planes of a tile of pixels resident in
      shared memory (TMA loads on a persistent grid); an approximate
      pass picks the candidate windows (a second approximate sweep finds
      them where there are several), which alone are scored exactly, and
      a pixel the filter cannot certify scans all its windows exactly
      (:func:`ssd_serial_filter_reference` is its plain version);
      ``rescore``, a (3,) int64 tensor on V's device, gains the windows
      scored exactly, the pixels that ran the whole exact scan and the
      pixels with more than one candidate (given where "thread" runs, it
      raises);
    - "thread" on any other input: one thread a pixel
      (``cols_per_thread`` = 1, 2 or 4 adjacent columns, blocks of 32 x
      ``rows_per_block`` threads), the IEEE root and division on every
      window.

    The choice follows S, as measured on uniform random inputs.  Where
    nearly every window lies within the filter's 3 delta of the least,
    as in the `tent` search of a camera frame (smooth texture), "tile"
    scores most windows twice and "thread" is the faster (PERF.md).

    On CPU tensors "thread" runs ``ssd_serial_reference`` and "tile" the
    plain filter; on the card every input must be contiguous and on the
    16-byte grid."""
    _check_ssd_inputs(V, K, mlo, mhi)
    S, H, W = V.shape
    tile = serial_design(S) == "tile" and H * W % 4 == 0
    if rescore is not None and (not tile or rescore.dtype != torch.int64
                                or tuple(rescore.shape) != (3,)
                                or rescore.device != V.device):
        raise ValueError('ssd_serial: rescore must be a (3,) int64 tensor '
                         'on V\'s device, and the kernel "tile"')
    if _device_of("ssd_serial", V, K, mlo, mhi) == "cpu":
        if not tile:
            return ssd_serial_reference(V, K, mlo, mhi)
        out, counts = ssd_serial_filter_reference(V, K, mlo, mhi)
        if rescore is not None:
            rescore += torch.tensor(counts)
        return out
    lib = probe_library().lib
    out = _search_outputs(V)
    ptrs = (V.data_ptr(), K.data_ptr(), mlo.data_ptr(), mhi.data_ptr())
    with torch.cuda.device(V.device):
        stream = torch.cuda.current_stream().cuda_stream
        if tile:
            status = lib.ssd_serial_tile_launch(
                *ptrs, S, H, W, *(x.data_ptr() for x in out),
                None if rescore is None else rescore.data_ptr(), stream)
        else:
            status = lib.ssd_serial_launch(
                *ptrs, S, H, W, cols_per_thread, rows_per_block,
                *(x.data_ptr() for x in out), stream)
    _launch("ssd_serial", status)
    ssd_serial.launches += 1
    return out


ssd_serial.launches = 0


# ------------------------------------------------------- two-pass search

def ssd_par_reference(V, K, mlo, mhi):
    """Plain version of the two-pass search (``_par_kernel``,
    benchmarks/exp_ssd.py:99): every window's error in the rsqrt form
    err = 2 - 2 corr rsqrt(|w|^2 + eps) rsqrt(|K|^2 + eps), sums left to
    right; then the minimum over the windows, which is NaN as soon as
    one error is NaN (``jnp.minimum``), the first window that equals it
    (bm; -1 where the minimum is >= 3e38) and its neighbours' errors
    (3e38 outside the windows).  No window equals a NaN minimum, so a
    pixel with a NaN error gets bm = M, the TPU kernel's own output,
    with ec = NaN, ep = the last window's error and en = 3e38."""
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
    # torch.argmin takes a NaN as the minimum: ec is then that NaN
    first = torch.argmin(errs, dim=0)
    ec = _take(errs, first)
    nan = torch.isnan(ec)
    best = torch.where(nan, M, first)
    ep = torch.where(best == 0, _INF, _take(errs, torch.clamp(best - 1,
                                                              min=0)))
    en = torch.where(best >= M - 1, _INF,
                     _take(errs, torch.clamp(best + 1, max=M - 1)))
    return (torch.where(ec >= _INF, -1, best).to(torch.int32), ec, ep, en)


def ssd_par(V, K, mlo, mhi):
    """The two-pass SSD window search.  Same inputs and outputs as
    ``ssd_search``; the errors are in the rsqrt form of
    :func:`ssd_par_reference`.  Two kernels, bit-equal where both run:

    - "tile" wherever it takes the input (H * W % 4 == 0 and S <= 896,
      see :func:`tile_config`): the planes of a tile of pixels resident
      in shared memory (TMA loads on a persistent grid), the running
      minimum in registers and the neighbours' errors recomputed from the
      resident samples;
    - "slab" on the other inputs: pass 1 writes every window's error to
      an (M, 128-pixel) slab in shared memory, pass 2 scans it; where
      the slab does not fit in a block's shared memory either (S > 458)
      it raises ValueError.

    On CPU tensors it runs :func:`ssd_par_reference`."""
    _check_ssd_inputs(V, K, mlo, mhi)
    if _device_of("ssd_par", V, K, mlo, mhi) == "cpu":
        return ssd_par_reference(V, K, mlo, mhi)
    S, H, W = V.shape
    lib = probe_library().lib
    try:
        tile_config(S, H, W, serial=False)
        launch = lib.ssd_par_tile_launch
    except ValueError as refused:
        if lib.ssd_par_shared_bytes(S) == 0:
            raise ValueError(f"ssd_par: neither kernel takes S={S} at "
                             f"{H}x{W}: {refused}; the error slab does "
                             "not fit in a block's shared memory") from None
        launch = lib.ssd_par_launch
    out = _search_outputs(V)
    with torch.cuda.device(V.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch("ssd_par", launch(
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


def quartiles(times):
    """(median, first quartile, third quartile) of a list of times."""
    q1, _, q3 = statistics.quantiles(times, n=4)
    return statistics.median(times), q1, q3


def run_probes(planes=PLANES, shape=SHAPE, log=print):
    """Time every copy-floor variant and ``torch.sum(V, 0)`` at each S on
    the card, the sum, the float4 floor and the default bulk-copy floor
    again with a clean L2, the serial "thread" kernel in every block
    shape where ssd_serial runs it, and ssd_serial (its fastest block
    shape), ssd_par and ssd_search in turns with ``cuda_times``; returns
    {S: {"floor": {variant: ms}, "serial": {(cols, rows): ms} (empty
    where "tile" runs), "turns": {"ssd_serial", "ssd_par", "ssd_search":
    [ms, ...]}, "rescore": (windows scored exactly, pixels that scanned,
    pixels with more than one candidate) of ssd_serial "tile" or None,
    "sum": ms, "clean": {"torch.sum", "threads", "bulk": ms}}} and logs
    one line per probe."""
    H, W = shape
    results = {}
    for S in planes:
        args = probe_inputs(S, H, W)
        gb = S * H * W * 4 / 1e6          # MB of V = GB/s at 1 ms
        floor = {v: cuda_ms(lambda v=v: ssd_copy_floor(args[0], v))
                 for v in COPY_VARIANTS}
        total = cuda_ms(lambda: torch.sum(args[0], 0))
        kernel = serial_design(S)
        serial = {} if kernel == "tile" else {
            v: cuda_ms(lambda v=v: ssd_serial(*args, *v))
            for v in SERIAL_VARIANTS}
        fastest = min(serial, key=serial.get) if serial else ()
        turns = cuda_times({
            "ssd_serial": lambda: ssd_serial(*args, *fastest),
            "ssd_par": lambda: ssd_par(*args),
            "ssd_search": lambda: ssd_search(*args)})
        rescore = None
        if kernel == "tile":
            counts = torch.zeros(3, dtype=torch.int64, device="cuda")
            ssd_serial(*args, rescore=counts)
            rescore = tuple(counts.tolist())
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
            log(f"S={S:3d} serial thread cols={cols} rows={rows:2d}: "
                f"{ms:.4f} ms, {gb / ms:.1f} GB/s")
        plan = tile_config(S, H, W, serial=False)
        log(f"S={S:3d} in turns, 20 rounds, median (quartiles): " + ", ".join(
            "{} {:.4f} ({:.4f}-{:.4f}) ms".format(name, *quartiles(times))
            for name, times in turns.items())
            + f"; ssd_serial runs {kernel}"
            + (f" (cols, rows = {fastest})" if serial else "")
            + f", ssd_par tile P={plan['tile']} x {plan['blocks_per_sm']} "
            f"blocks an SM, {plan['chunks']} chunks of {plan['chunk_rows']} "
            "planes")
        if rescore is not None:
            n_exact, n_scan, n_sweep = rescore
            log(f"S={S:3d} ssd_serial tile re-scores: "
                f"{n_exact / (H * W):.3f} exact windows a pixel (of {S - 4})"
                f", {n_scan} pixels scanned every window, {n_sweep} swept "
                "again for more than one candidate")
        search = statistics.median(turns["ssd_search"])
        log(f"S={S:3d} ssd_search: {search:.4f} ms, {gb / search:.1f} GB/s, "
            f"{min(floor.values()) / search:.3f} of the best floor")
        results[S] = dict(floor=floor, serial=serial, turns=turns,
                          rescore=rescore, sum=total, clean=clean)
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
