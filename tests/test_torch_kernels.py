"""The port's hand-written CUDA kernels against their plain PyTorch
versions, and the wrappers' input checks.

This file imports no JAX, so it runs on a machine with a card without
``tests/conftest.py`` (which imports JAX):

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda

Without a CUDA device the ``cuda`` tests skip (a kernel has no CPU form).
"""

import inspect
from functools import partial

import numpy as np
import pytest
import torch

from tadataka_torch.vo.semi_dense.sweep import (
    ssd_search, ssd_search_reference)

SSD_CASES = ["planted", "window_mask", "invalid_samples", "ties",
             "all_invalid", "ragged_rows"]
# the cases of ssd_serial "tile"'s candidate filter (see ssd_case)
FILTER_CASES = ["near_tie", "nan_key", "tiny_wn2"]
# window errors that are NaN (see nan_case)
NAN_CASES = ["nan_key_sample", "nan_key_rows", "inf_sample", "nan_after_best",
             "nan_first_in_bounds", "nan_window0", "overflow"]


def window_errors_np(V, K):
    """(M, H, W) unmasked errors of the SSD search in numpy float32:
    left-to-right sums of rounded products, IEEE root and division."""
    M = V.shape[0] - 4
    eps = np.float32(1e-16)
    kk = K[0] * K[0]
    corr = V[0:M] * K[0]
    wn2 = V[0:M] * V[0:M]
    for k in range(1, 5):
        kk = kk + K[k] * K[k]
        corr = corr + V[k:k + M] * K[k]
        wn2 = wn2 + V[k:k + M] * V[k:k + M]
    kn = np.sqrt(kk) + eps
    return np.float32(2.0) - (np.float32(2.0) * corr) / (np.sqrt(wn2) * kn
                                                          + eps)


def near_tie(V, K, gen, a=2, b=9):
    """Plant the key near window ``a`` and window ``b`` as a copy of it
    with one sample scaled by 1 +- 2^-k, chosen per pixel so that the
    two windows' exact errors differ by one ulp where a scale achieves it
    (an exact tie elsewhere).  Returns where it does.  An error e = 2 - q
    is rounded as q = 2 corr / denom is (the difference is exact), so one
    ulp here is one ulp of q: e_a and e_b are neighbours among the
    values the search can compute."""
    K[:] = V[a:a + 5] + np.float32(0.05) * gen.random(K.shape,
                                                       dtype=np.float32)
    V[b:b + 5] = V[a:a + 5]
    e_a = window_errors_np(V[a:a + 5], K)[0]
    q_a = np.float32(2.0) - e_a
    up = np.float32(2.0) - np.nextafter(q_a, np.float32(np.inf))
    down = np.float32(2.0) - np.nextafter(q_a, np.float32(-np.inf))
    done = np.zeros(e_a.shape, bool)
    for k in range(24, 8, -1):
        for j in range(5):
            for sign in (1, -1):
                w = V[a:a + 5].copy()
                w[j] = w[j] * np.float32(1 + sign * 2.0 ** -k)
                e_b = window_errors_np(w, K)[0]
                take = ((e_b == up) | (e_b == down)) & ~done
                V[b + j][take] = w[j][take]
                done |= take
    return done


def ssd_case(case, S, seed=7):
    """(V, K, mlo, mhi) float32 numpy inputs of one SSD search case
    (SSD_CASES, and FILTER_CASES: "near_tie", two windows whose exact
    errors differ by one ulp on most pixels; "nan_key", NaN in K on a
    quarter of the pixels; "tiny_wn2", rows of windows with samples
    scaled by 1e-20, 1e-9 and 1e-6 and a window of zeros, where the
    search's 1e-16 counts or wn2 is not normal)."""
    gen = np.random.default_rng(seed)
    H, W = (13, 37) if case == "ragged_rows" else (8, 64)
    V = gen.random((S, H, W)).astype(np.float32)
    M = S - 4
    K = V[6:11].copy()                                  # planted at m = 6
    mlo = np.zeros((H, W), np.float32)
    mhi = np.full((H, W), float(M - 1), np.float32)
    if case == "window_mask":
        mlo = gen.integers(0, M // 2, (H, W)).astype(np.float32)
        mhi = mlo + gen.integers(0, M // 2, (H, W)).astype(np.float32)
    elif case == "invalid_samples":
        V[gen.random(V.shape) < 0.2] = -1.0
    elif case == "ties":
        V[S - 5:] = V[6:11]           # the same window at m = 6 and M - 1
        V[:, :, :8] = 0.5             # constant columns: every window ties
    elif case == "all_invalid":
        V[:, :4] = -1.0               # rows with no valid sample at all
        mlo[4:6], mhi[4:6] = 1e9, -1e9   # rows with an empty window range
    elif case == "ragged_rows":
        V[gen.random(V.shape) < 0.2] = -1.0
        mlo = gen.integers(0, M // 2, (H, W)).astype(np.float32)
        mhi = mlo + 3.0 + gen.integers(0, M // 2, (H, W)).astype(np.float32)
    elif case == "near_tie":
        near_tie(V, K, gen)
    elif case == "nan_key":
        K[:, gen.random((H, W)) < 0.25] = np.nan
        K[2, 0, :] = np.nan           # one NaN sample in a row's keys
    elif case == "tiny_wn2":
        for row, scale in ((0, 1e-20), (1, 1e-9), (2, 1e-6)):
            V[:, row] *= np.float32(scale)
        V[3:8, 3] = 0.0               # window 3 of row 3: wn2 = 0, err 2
        V[3:8, 4, :32] = 0.0
        K[:, 4, :32] = 0.0            # kk = 0: the key norm is 1e-16
    return V, K, mlo, mhi


def nan_case(case, S=16, shape=(8, 16), seed=17):
    """(V, K, mlo, mhi) float32 numpy inputs (S >= 16 planes, H >= 8
    rows; tests/test_torch_ssd_nan.py holds them against the Pallas
    kernels at 16 planes and 8x16), the key planted at window 6 of every
    pixel (so most pixels have a clear
    best) and one kind of NaN error on part of the pixels:

    - "nan_key_sample": one NaN sample in the key of a quarter of them;
    - "nan_key_rows": the whole key NaN on rows 2-3;
    - "inf_sample": an infinite sample at a random plane of a quarter;
    - "nan_after_best": plane 11 infinite on rows 0-3, so windows 7-11
      are NaN, the first right after the best (en = NaN);
    - "nan_first_in_bounds": window bounds from 3 on rows 4-7 and plane 3
      infinite there: the first window in bounds is NaN, no best;
    - "nan_window0": plane 0 infinite on rows 0-3, every window allowed:
      window 0 is NaN, no best, en = NaN;
    - "overflow": samples of 1e20 on rows 0-1 (squares overflow to inf:
      err 2 where the key is finite), keys of 1e20 too on row 1 (corr
      and wn2 inf: NaN), keys of -1e20 on row 2 with samples of 1e19
      (2 corr overflows to -inf: err +inf in the rsqrt form)."""
    gen = np.random.default_rng(seed)
    H, W = shape
    M = S - 4
    V = gen.random((S, H, W)).astype(np.float32)
    K = V[6:11] + np.float32(0.01) * gen.random((5, H, W),
                                                dtype=np.float32)
    mlo = np.zeros((H, W), np.float32)
    mhi = np.full((H, W), float(M - 1), np.float32)
    some = gen.random((H, W)) < 0.25
    if case == "nan_key_sample":
        i, j = np.nonzero(some)
        K[gen.integers(0, 5, i.shape), i, j] = np.nan
    elif case == "nan_key_rows":
        K[:, 2:4] = np.nan
    elif case == "inf_sample":
        i, j = np.nonzero(some)
        V[gen.integers(0, S, i.shape), i, j] = np.inf
    elif case == "nan_after_best":
        V[11, :4] = np.inf
    elif case == "nan_first_in_bounds":
        mlo[4:] = 3.0
        V[3, 4:] = np.inf
    elif case == "nan_window0":
        V[0, :4] = np.inf
    elif case == "overflow":
        V[:, 0:2] = np.float32(1e20)
        K[:, 1] = np.float32(1e20)
        V[:, 2] = np.float32(1e19)
        K[:, 2] = np.float32(-1e20)
    return V, K, mlo, mhi


def tensors(arrays, device="cpu", dtype=torch.float32):
    return [torch.tensor(a, dtype=dtype, device=device) for a in arrays]


def search_case(case, S):
    """The inputs of an SSD_CASES, FILTER_CASES or NAN_CASES case."""
    return nan_case(case, S) if case in NAN_CASES else ssd_case(case, S)


def same_or_both_nan(a, b):
    """Equal, NaN in the same places (NaN payloads aside)."""
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(
        torch.where(a.isnan(), 0, a), torch.where(b.isnan(), 0, b))


def test_ssd_search_rejects_bad_input():
    V, K, mlo, mhi = tensors(ssd_case("planted", 16))
    with pytest.raises(ValueError, match="K.shape"):
        ssd_search(V, K[:4], mlo, mhi)
    with pytest.raises(ValueError, match="S >= 5"):
        ssd_search(V[:4], K, mlo, mhi)
    with pytest.raises(TypeError, match="float32"):
        ssd_search(V.double(), K, mlo, mhi)
    with pytest.raises(ValueError, match="mlo"):
        ssd_search(V, K, mlo[:, 1:], mhi)


def test_ssd_search_cpu_runs_the_plain_version_uncounted():
    args = tensors(ssd_case("invalid_samples", 16))
    before = ssd_search.launches
    for out, ref in zip(ssd_search(*args), ssd_search_reference(*args)):
        assert torch.equal(out, ref)
    assert ssd_search.launches == before


def off_the_grid(x):
    """A copy of ``x`` whose storage starts 4 bytes past the 16-byte
    grid."""
    y = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:]
    y.copy_(x.reshape(-1))
    return y.view(x.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", ["on", "off"])
@pytest.mark.parametrize("S", [16, 48])
@pytest.mark.parametrize("case", SSD_CASES + NAN_CASES)
def test_ssd_kernel_bit_equal_to_plain(case, S, grid):
    """On the card: the CUDA kernel against the plain version on the same
    CUDA tensors, bit for bit with NaN in the same places (NaN window
    errors placed by the Pallas kernel's rule), and one launch counted
    per call; with K off the 16-byte grid (``grid`` "off") the launcher
    runs the first kernel, one thread a pixel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    args = tensors(search_case(case, S), device="cuda")
    if grid == "off":
        args[1] = off_the_grid(args[1])
    ref = ssd_search_reference(*args)
    before = ssd_search.launches
    out = ssd_search(*args)
    torch.cuda.synchronize()
    assert ssd_search.launches == before + 1
    for port, plain in zip(out, ref):
        assert port.device.type == "cuda"
        assert same_or_both_nan(port, plain), (case, S, grid)
    if case in NAN_CASES:
        assert ref[1].isnan().any() or ref[3].isnan().any() or case in (
            "nan_first_in_bounds", "inf_sample")


# ------------------------------------------------- SSD probes (exp_ssd.py)

def test_probes_cpu_run_the_plain_versions_uncounted():
    """On CPU tensors each probe returns its plain version's bits and
    counts no launch."""
    from tadataka_torch.probes import exp_ssd as probes
    args = tensors(ssd_case("invalid_samples", 16))
    counts = [fn.launches for fn in (probes.ssd_copy_floor, probes.ssd_serial,
                                     probes.ssd_par)]
    assert torch.equal(probes.ssd_copy_floor(args[0]),
                       probes.ssd_copy_floor_reference(args[0]))
    for fn, ref in ((probes.ssd_serial, probes.ssd_serial_reference),
                    (probes.ssd_par, probes.ssd_par_reference)):
        for out, plain in zip(fn(*args), ref(*args)):
            assert torch.equal(out, plain)
    assert counts == [fn.launches for fn in (
        probes.ssd_copy_floor, probes.ssd_serial, probes.ssd_par)]


def cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")


@pytest.mark.cuda
@pytest.mark.parametrize("S", [16, 48, 128, 256])
@pytest.mark.parametrize("case", SSD_CASES + NAN_CASES)
def test_probe_kernels_against_plain(case, S):
    """On the card: the copy floor bit-equal to its plain version in
    every variant; ssd_serial in every block shape of its "thread"
    kernel (which it runs at S = 256) bit-equal to ssd_search and to the
    plain version; ssd_par bit-equal to its plain version; NaN in the
    same places throughout (each form by its Pallas kernel's rule); one
    launch counted per call."""
    cuda_or_skip()
    from tadataka_torch.probes import exp_ssd as probes
    arrays = search_case(case, S)
    if case == "ragged_rows":       # W = 37: the vector loads need W % 4
        arrays = tuple(a[..., :36] for a in arrays)
    args = tensors(arrays, device="cuda")
    for variant in probes.COPY_VARIANTS:
        before = probes.ssd_copy_floor.launches
        out = probes.ssd_copy_floor(args[0], variant)
        torch.cuda.synchronize()
        assert probes.ssd_copy_floor.launches == before + 1
        assert same_or_both_nan(out, probes.ssd_copy_floor_reference(
            args[0]))
    search = ssd_search(*args)
    for variant in probes.SERIAL_VARIANTS:
        out = probes.ssd_serial(*args, *variant)
        torch.cuda.synchronize()
        for a, b, c in zip(out, search, probes.ssd_serial_reference(*args)):
            assert same_or_both_nan(a, b) and same_or_both_nan(a, c)
    before = probes.ssd_par.launches
    out = probes.ssd_par(*args)
    ref = probes.ssd_par_reference(*args)
    torch.cuda.synchronize()
    assert probes.ssd_par.launches == before + 1
    for a, b in zip(out, ref):
        assert same_or_both_nan(a, b), (case, S)


@pytest.mark.cuda
def test_probe_kernels_refuse():
    """On the card: the copy floor's float4 variant refuses a W it cannot
    tile and its bulk-copy variants an H * W that is not a multiple of 4
    (the copies need 16-byte aligned planes)."""
    cuda_or_skip()
    from tadataka_torch.probes import exp_ssd as probes
    V = torch.rand((460, 4, 32), device="cuda")
    with pytest.raises(RuntimeError, match="launch failed"):
        probes.ssd_copy_floor(V[:, :, :30].contiguous(), ("threads", 4, 8))
    odd = torch.rand((8, 3, 31), device="cuda")
    for variant in probes.COPY_VARIANTS:
        if variant[0] == "bulk":
            with pytest.raises(RuntimeError, match="launch failed"):
                probes.ssd_copy_floor(odd, variant)
    assert torch.equal(probes.ssd_copy_floor(odd, ("threads", 1, 8)),
                       probes.ssd_copy_floor_reference(odd))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [16, 48, 128, 256])
@pytest.mark.parametrize("case", SSD_CASES + FILTER_CASES + NAN_CASES)
def test_tile_designs_against_plain(case, S):
    """On the card: ssd_serial bit-equal to ssd_search, to the plain
    version and to its plain filter; ssd_par bit-equal to its plain
    version; NaN in the same places throughout, each form placing NaN
    errors by its own Pallas kernel's rule (ssd_serial and ssd_search by
    _ssd_kernel's, ssd_par by _par_kernel's); one launch counted per
    call.  Both run "tile" but where it refuses the input: ssd_serial
    runs "thread" at S = 256 and at 13 x 37 ("ragged_rows", H * W % 4
    != 0), ssd_par "slab" at 13 x 37."""
    cuda_or_skip()
    from tadataka_torch.probes import exp_ssd as probes
    args = tensors(search_case(case, S), device="cuda")
    search = ssd_search(*args)
    plain = probes.ssd_serial_reference(*args)
    filtered, _ = probes.ssd_serial_filter_reference(*args)
    before = probes.ssd_serial.launches
    out = probes.ssd_serial(*args)
    torch.cuda.synchronize()
    assert probes.ssd_serial.launches == before + 1
    for a, *others in zip(out, search, plain, filtered):
        for b in others:
            assert same_or_both_nan(a, b), (case, S)
    ref = probes.ssd_par_reference(*args)
    before = probes.ssd_par.launches
    out = probes.ssd_par(*args)
    torch.cuda.synchronize()
    assert probes.ssd_par.launches == before + 1
    for a, b in zip(out, ref):
        assert same_or_both_nan(a, b), (case, S)
    if case in ("nan_key", "nan_key_rows", "nan_key_sample"):
        assert torch.isnan(ref[1]).any() and torch.isnan(plain[3]).any()


@pytest.mark.cuda
def test_tile_rescore_counts():
    """On the card: ssd_serial "tile" adds to ``rescore`` the windows it
    scored exactly, the pixels that scanned every window and the pixels
    with more than one candidate, as its plain filter counts them: two
    or three windows a pixel on the planted case, a second sweep on
    every pixel of the tied case, a scan on every pixel whose key is
    NaN."""
    cuda_or_skip()
    from tadataka_torch.probes import exp_ssd as probes
    for case in ("planted", "ties", "nan_key"):
        args = tensors(ssd_case(case, 48), device="cuda")
        rescore = torch.zeros(3, dtype=torch.int64, device="cuda")
        probes.ssd_serial(*args, rescore=rescore)
        probes.ssd_serial(*args, rescore=rescore)
        n_exact, n_scan, n_sweep = rescore.tolist()
        _, plain = probes.ssd_serial_filter_reference(*args)
        assert (n_scan, n_sweep) == (2 * plain[1], 2 * plain[2]), case
        if case == "planted":
            assert 2 * 2 * 8 * 64 <= n_exact <= 2 * 3 * 8 * 64
            assert n_scan == n_sweep == 0
        if case == "ties":
            assert n_sweep == 2 * 8 * 64


@pytest.mark.cuda
def test_probe_searches_fall_back_or_refuse():
    """On the card: where "tile" refuses the input, ssd_serial runs
    "thread" and ssd_par "slab", each bit-equal to its plain version:
    H * W % 4 != 0 (a TMA box reads whole 16-byte vectors; 7 x 63) and,
    for ssd_serial, S = 1000 (two tiles of S planes do not fit in a
    block's shared memory even at 32 pixels a tile; 896 fits); ssd_par
    runs "tile" at S = 460, past the slab's 458, where H * W % 4 == 0,
    and raises where neither kernel takes the input (S = 1000, and S =
    460 at 7 x 63); both raise on a tensor off the 16-byte grid, which
    they launch nothing for."""
    cuda_or_skip()
    from tadataka_torch.probes import exp_ssd as probes

    def search(S, H, W):
        return [torch.rand((S, H, W), device="cuda"),
                torch.rand((5, H, W), device="cuda"),
                torch.zeros((H, W), device="cuda"),
                torch.full((H, W), S - 5.0, device="cuda")]

    odd = [x[..., :7, :63].contiguous()
           for x in tensors(ssd_case("planted", 16), device="cuda")]
    big, wide, odd_wide = search(1000, 4, 32), search(460, 4, 32), search(
        460, 7, 63)
    shifted = tensors(ssd_case("planted", 16), device="cuda")
    shifted[0] = off_the_grid(shifted[0])
    counts = [probes.ssd_serial.launches, probes.ssd_par.launches]
    for args in (odd, big):
        assert all(same_or_both_nan(a, b) for a, b in zip(
            probes.ssd_serial(*args), probes.ssd_serial_reference(*args)))
    for args in (odd, wide):
        assert all(same_or_both_nan(a, b) for a, b in zip(
            probes.ssd_par(*args), probes.ssd_par_reference(*args)))
    torch.cuda.synchronize()
    assert [probes.ssd_serial.launches, probes.ssd_par.launches] == [
        counts[0] + 2, counts[1] + 2]
    for args in (big, odd_wide):
        with pytest.raises(ValueError, match="shared memory"):
            probes.ssd_par(*args)
    for fn in (probes.ssd_serial, probes.ssd_par):
        with pytest.raises(ValueError, match="16-byte"):
            fn(*shifted)
    assert [probes.ssd_serial.launches, probes.ssd_par.launches] == [
        counts[0] + 2, counts[1] + 2]
    probes.tile_config(896, 4, 32, serial=True)


def test_copy_floor_variants_on_cpu():
    """On CPU tensors every copy-floor variant returns the plain
    version's bits, at any H * W, and counts no launch; an unknown
    variant raises."""
    from tadataka_torch.probes import exp_ssd as probes
    V = torch.from_numpy(
        np.random.default_rng(2).random((5, 13, 37)).astype(np.float32))
    before = probes.ssd_copy_floor.launches
    for variant in probes.COPY_VARIANTS:
        assert torch.equal(probes.ssd_copy_floor(V, variant),
                           probes.ssd_copy_floor_reference(V))
    assert probes.ssd_copy_floor.launches == before
    assert probes.COPY_DEFAULT in probes.COPY_VARIANTS
    with pytest.raises(ValueError, match="no variant"):
        probes.ssd_copy_floor(V, ("tma", 8, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 5, 16, 48, 128])
def test_bulk_copy_floor_bit_equal_to_plain(S):
    """On the card: every bulk-copy variant of the copy floor bit-equal
    to the plain left-to-right sum (-0.0 kept), with fewer planes than
    ring stages (S = 1, 5), ragged last tiles (13 x 36) and 480x640, one
    launch counted per call."""
    cuda_or_skip()
    from tadataka_torch.probes import exp_ssd as probes
    gen = torch.Generator(device="cuda").manual_seed(S)
    for shape in ((13, 36), (480, 640)):
        V = torch.rand((S, *shape), generator=gen, device="cuda") - 0.5
        V[:, 0, :4] = -0.0
        ref = probes.ssd_copy_floor_reference(V)
        for variant in probes.COPY_VARIANTS:
            if variant[0] != "bulk":
                continue
            before = probes.ssd_copy_floor.launches
            out = probes.ssd_copy_floor(V, variant)
            torch.cuda.synchronize()
            assert probes.ssd_copy_floor.launches == before + 1
            assert torch.equal(out.view(torch.int32),
                               ref.view(torch.int32)), (shape, variant)


@pytest.mark.cuda
def test_ssd_kernel_on_a_rect_stack_of_256_planes():
    """On the card: ssd_search on a rect plan's stack at its largest size
    (256 shifted copies of one 480x640 image, -1 fill columns, sentinel
    bounds 1e9 / -1e9 where the key template leaves the image), bit-equal
    to the plain version."""
    cuda_or_skip()
    from tadataka_torch.core.shiftwarp import const_shift_cols
    from tadataka_torch.vo.semi_dense.sweep_rect import (
        _key_template, _shift_stack)
    gen = torch.Generator(device="cuda").manual_seed(3)
    image = torch.rand((480, 640), generator=gen, device="cuda")
    shift = torch.tensor([-5.5, -90.0], device="cuda")
    V = _shift_stack(const_shift_cols(image, shift[0]), 256, fill=-1.0)
    K = _key_template(const_shift_cols(image, shift[1]))
    lo = torch.randint(0, 252, (480, 640), generator=gen,
                       device="cuda").float()
    off = ~torch.all(K >= 0.0, dim=0)
    mlo = torch.where(off, 1e9, lo - 6.0)
    mhi = torch.where(off, -1e9, lo + 6.0)
    out = ssd_search(V, K, mlo, mhi)
    ref = ssd_search_reference(V, K, mlo, mhi)
    torch.cuda.synchronize()
    for port, plain in zip(out, ref):
        assert torch.equal(port, plain)
    assert (out[0] >= 0).float().mean().item() > 0.3


def bounds_case(case, S, shape, seed):
    """(V, K, mlo, mhi) of one bounds case on the card; where H*W % 4 is
    not 0, K and mlo start off the 16-byte grid as well:
    - "special": bounds NaN, +-inf, 1e9 / -1e9, fractional, -0.0, below
      0, past M - 1, mlo > mhi;
    - "coherent": narrow ranges (1-4 windows) shared by runs of 64 pixels,
      the key planted inside them, so that a tile skips most planes;
    - "invalid_ties": a third of the pixels with no valid sample (whole
      tiles), constant columns where every window ties, the key planted
      at two windows, sentinel bounds on a band;
    - "extreme": samples and key values of 0, 1e-30, subnormal 1e-40,
      1e10 and 1e15 among the uniform ones, so that window norms and
      correlations are 0, tiny and huge, and a fifth of the pixels see
      only zeros (the ring's fast root and division hand these to the
      IEEE operators; no error overflows to NaN: the NaN cases are
      NAN_CASES)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    H, W = shape
    N, M = H * W, S - 4
    V = torch.rand((S, N), generator=gen, device="cuda")
    V[torch.rand((S, N), generator=gen, device="cuda") < 0.1] = -1.0
    K = torch.rand((5, N), generator=gen, device="cuda")
    mlo = torch.zeros(N, device="cuda")
    mhi = torch.full((N,), float(M - 1), device="cuda")
    pixels = torch.arange(N, device="cuda")
    if case == "special":
        specials = torch.tensor(
            [float("nan"), float("inf"), -float("inf"), 1e9, -1e9, -2.5,
             -0.0, 0.5, M - 1.5, M - 1.0, M - 0.25, M + 3.5, 2.25],
            device="cuda")
        pick = torch.randint(0, len(specials), (2, N), generator=gen,
                             device="cuda")
        frac = torch.rand((2, N), generator=gen, device="cuda") * (M + 4) - 2
        half = torch.rand(N, generator=gen, device="cuda") < 0.5
        mlo = torch.where(half, specials[pick[0]], frac[0])
        mhi = torch.where(half, specials[pick[1]], frac[1])
    elif case == "coherent":
        centre = torch.randint(0, M, (N // 64 + 1,), generator=gen,
                               device="cuda")[pixels // 64]
        width = torch.randint(0, 4, (N,), generator=gen, device="cuda")
        mlo = (centre - width // 2).float()
        mhi = torch.minimum(mlo + width, torch.tensor(M - 1.0,
                                                      device="cuda"))
        at = torch.clamp(mlo.long(), 0, M - 1)
        for k in range(5):
            V[at + k, pixels] = K[k]
    elif case == "extreme":
        values = torch.tensor([0.0, 1e-30, 1e-40, 1e10, 1e15],
                              device="cuda")
        for x in (V, K):
            pick = torch.randint(0, 2 * len(values), x.shape, generator=gen,
                                 device="cuda")
            x[:] = torch.where(pick < len(values),
                               values[pick % len(values)], x)
        V[:, pixels % 5 == 0] = 0.0
    else:
        V[0:5] = K
        if M > 1:
            V[M - 1:M + 4] = K
        V[:, : N // 3] = -1.0
        col = pixels % W < 3
        V[:, col] = 0.5
        K[:, col] = 0.5
        band = (pixels // W) % 7 == 3
        mlo = torch.where(band, 1e9, mlo)
        mhi = torch.where(band, -1e9, mhi)
    if N % 4:
        # odd bases too: every row of the ring's stages is misaligned
        K_odd = torch.empty(5 * N + 1, device="cuda")[1:]
        K_odd.copy_(K.reshape(-1))
        mlo_odd = torch.empty(N + 3, device="cuda")[3:]
        mlo_odd.copy_(mlo)
        K, mlo = K_odd, mlo_odd
    return (V.reshape(S, H, W), K.reshape(5, H, W), mlo.reshape(H, W),
            mhi.reshape(H, W))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["special", "coherent", "invalid_ties",
                                  "extreme"])
@pytest.mark.parametrize("S", [5, 6, 7, 9, 48, 256])
@pytest.mark.parametrize("shape", [(37, 41), (13, 38), (479, 641),
                                   (24, 40)])
def test_ssd_designs_bit_equal_on_odd_shapes_and_bounds(shape, S, case):
    """On the card: ssd_search bit-equal to the plain version when H*W %
    4 is 1, 2 or 3 and K and mlo start off the 16-byte grid (the
    launcher runs the thread kernel there), and at 24x40 (the ring's TMA
    boxes), with fewer planes than a stage holds (S = 5-9), on NaN,
    infinite, sentinel, fractional and crossed bounds, tile-coherent
    narrow ranges and all-invalid tiles and ties; one launch counted per
    call."""
    cuda_or_skip()
    args = bounds_case(case, S, shape, seed=S * 7 + shape[1])
    ref = ssd_search_reference(*args)
    before = ssd_search.launches
    out = ssd_search(*args)
    torch.cuda.synchronize()
    assert ssd_search.launches == before + 1
    for port, plain in zip(out, ref):
        assert torch.equal(port, plain), (shape, S, case)
    if case in ("coherent", "invalid_ties"):
        assert (ref[0] >= 0).any()
    if case == "invalid_ties":
        assert (ref[0] < 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,ring", [((24, 40), 1), ((480, 640), 1),
                                        ((37, 41), 0), ((479, 641), 0)])
def test_ring_plan_takes_whole_vectors_only(shape, ring):
    """On the card: the ring's plan takes a shape exactly when its
    planes are whole 16-byte vectors (H*W % 4 == 0), with tiles of a
    multiple of 4 pixels that cover the image on a grid of at most the
    compiled blocks an SM."""
    cuda_or_skip()
    from tadataka_torch.vo.semi_dense.sweep import ring_config
    H, W = shape
    plan = ring_config(48, H, W)
    consumers, _, _, ctas = plan["shape"]
    assert plan["ring"] == ring
    assert plan["tile"] % 4 == 0 and plan["tile"] <= consumers
    assert plan["tiles"] == -(-H * W // plan["tile"])
    assert plan["blocks_per_sm"] <= ctas
    assert plan["grid"] <= plan["tiles"]


# ---------------------------------------- gather probes (benchmarks/*gather*)

def gather_case(shape, S=None, seed=11):
    """Seeded numpy inputs with planted hard indices: the first entries
    are -n - 1, -n, -1, 0, n - 1, n (n the gathered axis' length), the
    rest uniform in [-2n, 2n).  Returns (img, idx) for the flat case
    (``S`` rows of H*W indices) or (img, rows, cols) for the axis case."""
    gen = np.random.default_rng(seed)
    H, W = shape
    img = gen.random((H, W)).astype(np.float32)

    def indices(n, size):
        idx = gen.integers(-2 * n, 2 * n, size).astype(np.int32)
        flat = idx.reshape(-1)
        flat[:6] = [-n - 1, -n, -1, 0, n - 1, n]
        return idx

    if S is not None:
        return img, indices(H * W, (S, H * W))
    return img, indices(H, (H, W)), indices(W, (H, W))


def test_gather_probes_cpu_run_the_plain_versions_uncounted():
    """On CPU tensors each gather wrapper returns its plain version's
    bits and counts no launch; a wrong dtype or shape raises."""
    from tadataka_torch.probes import gather as g
    counts = [fn.launches for fn in g.WRAPPERS]
    img, rows, cols = tensors(gather_case((7, 9))[:1]) + tensors(
        gather_case((7, 9))[1:], dtype=torch.int32)
    assert g.same_bits(g.take_along_axis0(img, rows),
                       g.take_along_axis_reference(img, rows, 0))
    assert g.same_bits(g.take_along_axis1(img, cols),
                       g.take_along_axis_reference(img, cols, 1))
    assert g.same_bits(g.multi_warp(img, rows, cols, 5),
                       g.multi_warp_reference(img, rows, cols, 5))
    img2, idx = gather_case((7, 9), S=3)
    img2, idx = torch.from_numpy(img2), torch.from_numpy(idx)
    assert g.same_bits(g.flat_take(img2, idx),
                       g.flat_take_reference(img2, idx))
    assert g.same_bits(g.flat_take_rows(img2, idx),
                       g.flat_take_rows_reference(img2, idx))
    assert counts == [fn.launches for fn in g.WRAPPERS]
    with pytest.raises(ValueError, match="int32"):
        g.flat_take(img2, idx.long())
    with pytest.raises(ValueError, match="shape"):
        g.take_along_axis0(img, rows[:, 1:])
    with pytest.raises(ValueError, match="no kernel for device"):
        g.flat_take(img2.to("meta"), idx.to("meta"))


# an input whose column strip fits in a block's 227 KB ("strip") and one
# whose strip does not, on which the card runs the first kernel
STRIP_SHAPES = {"strip": (11, 37), "thread": (2000, 9)}


@pytest.mark.parametrize("kernel", list(STRIP_SHAPES))
def test_strip_designs_on_cpu(kernel):
    """take_along_axis0 and multi_warp take no design (the card's
    launchers pick the kernel from the input); on CPU tensors they return
    the plain version's bits on an input of each kernel, with planted
    edge indices, and count no launch."""
    from tadataka_torch.probes import gather as g
    assert list(inspect.signature(g.take_along_axis0).parameters) == [
        "img", "idx"]
    assert list(inspect.signature(g.multi_warp).parameters) == [
        "img", "idxr", "idxc", "S"]
    img, rows, cols = gather_case(STRIP_SHAPES[kernel])
    img = torch.from_numpy(img)
    rows, cols = torch.from_numpy(rows), torch.from_numpy(cols)
    counts = [g.take_along_axis0.launches, g.multi_warp.launches]
    out = g.take_along_axis0(img, rows)
    ref = g.take_along_axis_reference(img, rows, 0)
    assert torch.isnan(ref).any() and g.same_bits(out, ref)
    assert g.same_bits(g.multi_warp(img, rows, cols, 3),
                       g.multi_warp_reference(img, rows, cols, 3))
    assert counts == [g.take_along_axis0.launches, g.multi_warp.launches]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(480, 640), (479, 641), (5, 3),
                                   (300, 37), (300, 36)])
def test_gather_kernels_bit_equal_to_plain(shape):
    """On the card: each of the five gather kernels against its plain
    version on the same CUDA tensors, bit for bit with NaN in the same
    places, on planted negative, out-of-range and edge indices, with odd
    sizes (S = 20 index rows, N = H*W not a multiple of 2048);
    take_along_axis0 and multi_warp stage their strips by 16-byte copies
    at 480x640 and 300x36 (a last strip of 4 columns) and by plain loads
    at 479x641, 5x3 and 300x37 (H > 256, a last strip of 5 columns); one
    launch counted per call."""
    cuda_or_skip()
    from tadataka_torch.probes import gather as g
    img, rows, cols = gather_case(shape)
    img = torch.tensor(img, device="cuda")
    rows, cols = tensors((rows, cols), device="cuda", dtype=torch.int32)
    flat_img, idx = gather_case(shape, S=20)
    flat_img = torch.tensor(flat_img, device="cuda")
    idx = torch.tensor(idx, device="cuda")
    calls = [
        (g.take_along_axis0, (img, rows),
         g.take_along_axis_reference(img, rows, 0)),
        (g.take_along_axis1, (img, cols),
         g.take_along_axis_reference(img, cols, 1)),
        (g.multi_warp, (img, rows, cols, 16),
         g.multi_warp_reference(img, rows, cols, 16)),
        (g.flat_take, (flat_img, idx), g.flat_take_reference(flat_img, idx)),
        (g.flat_take_rows, (flat_img, idx),
         g.flat_take_rows_reference(flat_img, idx))]
    for wrapper, (fn, args, ref) in zip(g.WRAPPERS, calls):
        before = wrapper.launches
        out = fn(*args)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        assert out.device.type == "cuda"
        assert g.same_bits(out, ref), wrapper.__name__
    assert torch.isnan(calls[0][2]).any() and torch.isnan(calls[4][2]).any()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [STRIP_SHAPES["thread"], (1900, 640)])
def test_strip_designs_take_a_tall_image(shape):
    """On the card: at 2000 x 9 and 1900 x 640 the column strip does not
    fit in a block's shared memory (multi_warp: 250 KB, 238 KB;
    take_along_axis0 with its band of idx: 252 KB, 277 KB), and the
    launchers run the first kernel: bit-equal to the plain versions, on
    planted edge indices, one launch counted per call."""
    cuda_or_skip()
    from tadataka_torch.probes import gather as g
    img, rows, cols = gather_case(shape)
    img = torch.tensor(img, device="cuda")
    rows, cols = tensors((rows, cols), device="cuda", dtype=torch.int32)
    counts = [g.take_along_axis0.launches, g.multi_warp.launches]
    out = g.take_along_axis0(img, rows)
    assert g.same_bits(out, g.take_along_axis_reference(img, rows, 0))
    out = g.multi_warp(img, rows, cols, 4)
    assert g.same_bits(out, g.multi_warp_reference(img, rows, cols, 4))
    assert [g.take_along_axis0.launches, g.multi_warp.launches] == [
        counts[0] + 1, counts[1] + 1]


@pytest.mark.cuda
def test_empty_launch_runs():
    """On the card: the empty kernel that sets the launch floor launches
    and counts nothing."""
    cuda_or_skip()
    from tadataka_torch.probes import gather as g
    counts = [fn.launches for fn in g.WRAPPERS]
    g.empty_launch()
    torch.cuda.synchronize()
    assert counts == [fn.launches for fn in g.WRAPPERS]


def test_flat_take_rows_designs_on_cpu():
    """flat_take_rows takes no design; on CPU tensors it returns the plain
    version's bits and counts no launch."""
    from tadataka_torch.probes import gather as g
    assert list(inspect.signature(g.flat_take_rows).parameters) == [
        "img", "idx"]
    img, idx = (torch.from_numpy(x) for x in gather_case((5, 7), S=3))
    before = g.flat_take_rows.launches
    assert g.same_bits(g.flat_take_rows(img, idx),
                       g.flat_take_rows_reference(img, idx))
    assert g.flat_take_rows.launches == before


def test_row_and_band_designs_on_cpu():
    """On CPU tensors take_along_axis1 and flat_take, and the first
    kernel of each, return the plain versions' bits, with planted edge
    indices and S*N % 4 != 0, and count no launch; neither wrapper takes
    a design or band option, and the first kernel is only theirs."""
    from tadataka_torch.probes import gather as g
    assert list(inspect.signature(g.take_along_axis1).parameters) == [
        "img", "idx"]
    assert list(inspect.signature(g.flat_take).parameters) == ["img", "idx"]
    img, _, cols = (torch.from_numpy(x) for x in gather_case((11, 37)))
    fimg, idx = (torch.from_numpy(x) for x in gather_case((13, 7), S=3))
    counts = [g.take_along_axis1.launches, g.flat_take.launches]
    ref = g.take_along_axis_reference(img, cols, 1)
    assert torch.isnan(ref).any()
    assert g.same_bits(g.take_along_axis1(img, cols), ref)
    assert g.same_bits(g.first_kernel(g.take_along_axis1, img, cols), ref)
    ref = g.flat_take_reference(fimg, idx)
    assert g.same_bits(g.flat_take(fimg, idx), ref)
    assert g.same_bits(g.first_kernel(g.flat_take, fimg, idx), ref)
    assert counts == [g.take_along_axis1.launches, g.flat_take.launches]
    with pytest.raises(TypeError):
        g.take_along_axis1(img, cols, design="thread")
    with pytest.raises(TypeError):
        g.flat_take(fimg, idx, band_bytes=16)
    with pytest.raises(ValueError, match="not for"):
        g.first_kernel(g.take_along_axis0, img, cols)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(480, 640), (479, 641), (5, 3),
                                   (300, 37), (300, 36), (3, 58120)])
def test_take_along_axis1_row_bit_equal_to_plain(shape):
    """On the card: take_along_axis1 and its first kernel ("thread")
    bit-equal to the plain version, NaN in the same places, on planted
    negative, out-of-range and edge indices: "row" stages its band of
    rows by 16-byte copies at 480x640 and 300x36, by plain loads at
    479x641, 5x3 and 300x37, and runs the "thread" kernel where a row
    passes 227 KB (58120 columns); one launch counted per call."""
    cuda_or_skip()
    from tadataka_torch.probes import gather as g
    img, _, cols = gather_case(shape)
    img = torch.tensor(img, device="cuda")
    cols = torch.tensor(cols, device="cuda")
    ref = g.take_along_axis_reference(img, cols, 1)
    assert torch.isnan(ref).any()
    for design, call in (("row", g.take_along_axis1), ("thread", partial(
            g.first_kernel, g.take_along_axis1))):
        before = g.take_along_axis1.launches
        out = call(img, cols)
        torch.cuda.synchronize()
        assert g.take_along_axis1.launches == before + 1
        assert g.same_bits(out, ref), (shape, design)


@pytest.mark.cuda
@pytest.mark.parametrize("shape, S, N", [
    ((480, 640), 64, 307200), ((480, 640), 20, 307200),
    ((480, 640), 7, 1003), ((200, 300), 9, 4099), ((1000, 1000), 3, 5001),
    ((24, 40), 3, 5), ((24, 40), 1, 1), ((24, 40), 40, 33), ((1, 4), 5, 7),
    ((479, 641), 20, 307039), ((5, 3), 3, 5)])
def test_flat_take_band_bit_equal_to_plain(shape, S, N):
    """On the card: flat_take and its first kernel ("thread") bit-equal
    to the plain version on planted negative, past-the-end and edge
    indices (clipped): "band" at the probe's shape, with a tail of S*N %
    4 = 1, 3 and chunks past the end of the indices (blocks of a cluster
    with no slot), with a last band shorter than the rest (480x640,
    200x300, 1000x1000), one band of the whole image and one of a single
    16-byte piece (1x4); an image of H*W % 4 != 0 floats (479x641, 5x3)
    runs the first kernel; one launch counted per call."""
    cuda_or_skip()
    from tadataka_torch.probes import gather as g
    img, idx = gather_case(shape, S=S)
    img = torch.tensor(img, device="cuda")
    idx = torch.tensor(np.resize(idx, (S, N)), device="cuda")
    ref = g.flat_take_reference(img, idx)
    for design, call in (("band", g.flat_take),
                         ("thread", partial(g.first_kernel, g.flat_take))):
        before = g.flat_take.launches
        out = call(img, idx)
        torch.cuda.synchronize()
        assert g.flat_take.launches == before + 1
        assert g.same_bits(out, ref), (shape, S, N, design)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 7, 20])
@pytest.mark.parametrize("N", [1001, 1002, 1003])
def test_flat_take_rows_odd_sizes(N, S):
    """On the card: flat_take_rows bit-equal to its plain version, NaN in
    the same places, when S * N is not a multiple of 4 or 8 (row starts
    off the 16-byte grid, a scalar tail), on a 37x53 image with planted
    edge indices; one launch counted per call."""
    cuda_or_skip()
    from tadataka_torch.probes import gather as g
    img, idx = gather_case((37, 53), S=S)
    img = torch.tensor(img, device="cuda")
    idx = torch.tensor(np.resize(idx, (S, N)), device="cuda")
    before = g.flat_take_rows.launches
    out = g.flat_take_rows(img, idx)
    torch.cuda.synchronize()
    assert g.flat_take_rows.launches == before + 1
    ref = g.flat_take_rows_reference(img, idx)
    assert torch.isnan(ref).any()
    assert g.same_bits(out, ref)


@pytest.mark.cuda
def test_flat_take_rows_takes_a_large_image():
    """On the card: flat_take_rows takes an image larger than the shared
    memory of a cluster of 8 blocks (2 MB)."""
    cuda_or_skip()
    from tadataka_torch.probes import gather as g
    img = torch.rand((500, 1000), device="cuda")
    idx = torch.randint(0, img.numel(), (2, 1000), device="cuda",
                        dtype=torch.int32)
    assert g.same_bits(g.flat_take_rows(img, idx),
                       g.flat_take_rows_reference(img, idx))


# ------------------------------------- PnP normal equations (pnp_normal.cu)

def pnp_case(B, n, seed=0, zero_weights=False, nan_point=False):
    """(R, t, points, keypoints, weights) float32 numpy inputs of
    ``pnp_normal``: B poses near the identity, n points 4-6 m ahead, noisy
    keypoints; ``zero_weights``: every third weight 0; ``nan_point``:
    batch entry 0's point 1 at z + 1e-16 = 0 (its rows NaN or infinite)."""
    g = np.random.default_rng(seed)
    v = g.normal(0, 0.05, (B, 3))
    angle = np.linalg.norm(v, axis=1)[:, None, None]
    K = np.zeros((B, 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -v[:, 2], v[:, 1], -v[:, 0]
    K = (K - K.transpose(0, 2, 1)) / angle
    R = np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K
    t = g.normal(0, 0.2, (B, 3))
    X = g.uniform(-1, 1, (B, n, 3)) + [0.0, 0.0, 5.0]
    kp = g.normal(0, 0.2, (B, n, 2))
    w = g.random((B, n))
    if zero_weights:
        w[:, ::3] = 0.0
    R, t, X, kp, w = (a.astype(np.float32) for a in (R, t, X, kp, w))
    if nan_point and n > 1:
        R[0], t[0] = np.eye(3, dtype=np.float32), 0.0
        X[0, 1] = [0.5, -0.25, -1e-16]
    return R, t, X, kp, w


def same_bit_patterns(a, b):
    """The same float32 bits everywhere, NaN and the sign of 0 included."""
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def test_pnp_normal_rejects_bad_input():
    from tadataka_torch.pose_estimation.pnp import pnp_normal
    R, t, X, kp, w = (torch.tensor(a) for a in pnp_case(2, 5))
    with pytest.raises(ValueError, match="points"):
        pnp_normal(R, t, X[0], kp, w)
    with pytest.raises(ValueError, match="keypoints"):
        pnp_normal(R, t, X, kp[:, :4], w)
    with pytest.raises(ValueError, match="weights"):
        pnp_normal(R, t, X, kp, w[:1])
    with pytest.raises(TypeError, match="float32"):
        pnp_normal(R.double(), t, X, kp, w)


def test_pnp_normal_cpu_runs_the_plain_version_uncounted():
    from tadataka_torch.pose_estimation.pnp import (
        pnp_normal, pnp_normal_reference)
    from tadataka_torch.utils.timing import trace
    args = [torch.tensor(a) for a in pnp_case(3, 7, zero_weights=True)]
    with trace() as tr:
        out = pnp_normal(*args)
    assert same_bit_patterns(out, pnp_normal_reference(*args))
    assert "pnp.normal_kernel" not in tr.counts


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,zero_weights,nan_point", [
    (1, 1, False, False), (1, 3, False, False), (1, 1000, True, False),
    (1, 2048, False, False), (1, 2049, True, False), (1, 5000, True, True),
    (512, 3, False, False), (512, 3, True, True), (3, 37, True, True)])
def test_pnp_normal_kernel_bit_equal_to_plain(B, n, zero_weights, nan_point):
    """On the card: the normal-equation kernel against the plain version
    on the same CUDA tensors, bit for bit (NaN bit patterns and the signs
    of 0 too), and one launch counted per call."""
    cuda_or_skip()
    from tadataka_torch.pose_estimation.pnp import (
        pnp_normal, pnp_normal_reference)
    from tadataka_torch.utils.timing import trace
    args = [torch.tensor(a, device="cuda") for a in pnp_case(
        B, n, seed=B * 10007 + n, zero_weights=zero_weights,
        nan_point=nan_point)]
    ref = pnp_normal_reference(*args)
    with trace() as tr:
        out = pnp_normal(*args)
    torch.cuda.synchronize()
    assert tr.counts["pnp.normal_kernel"] == {None: 1}
    assert out.shape == (B, 6, 7) and out.device.type == "cuda"
    assert ref[0].isnan().any() == (nan_point and n > 1)
    assert same_bit_patterns(out, ref), (B, n)


@pytest.mark.cuda
def test_pnp_normal_kernel_refuses():
    """On the card: a non-contiguous input raises, and so does an empty
    batch or point set, which the launcher refuses; nothing falls back."""
    cuda_or_skip()
    from tadataka_torch.pose_estimation.pnp import pnp_normal
    R, t, X, kp, w = (torch.tensor(a, device="cuda") for a in pnp_case(2, 9))
    with pytest.raises(ValueError, match="contiguous"):
        pnp_normal(R.transpose(-1, -2), t, X, kp, w)
    with pytest.raises(RuntimeError, match="CUDA error"):
        pnp_normal(R[:0], t[:0], X[:0], kp[:0], w[:0])
    with pytest.raises(RuntimeError, match="CUDA error"):
        pnp_normal(R, t, X[:, :0].contiguous(), kp[:, :0].contiguous(),
                   w[:, :0].contiguous())


@pytest.mark.cuda
def test_pnp_refinement_launches_the_kernel_once_a_step():
    """On the card: one solve_pnp_ransac counts exactly 15 launches of
    the normal-equation kernel (its 15 Gauss-Newton steps) under
    "pnp.normal_kernel"."""
    cuda_or_skip()
    from tadataka_torch.pose_estimation.pnp import (
        GN_ITERATIONS, solve_pnp_ransac)
    from tadataka_torch.features.ransac import default_generator
    from tadataka_torch.utils.timing import trace
    R, t, X, kp, _ = pnp_case(1, 200, seed=3)
    P = X[0] @ R[0].T + t[0]
    kp = (P[:, :2] / P[:, 2:]).astype(np.float32)
    points, keypoints = torch.tensor(X[0], device="cuda"), torch.tensor(
        kp, device="cuda")
    mask = torch.ones(200, dtype=torch.bool, device="cuda")
    with trace() as tr:
        pose, inliers = solve_pnp_ransac(points, keypoints, mask,
                                         default_generator("cuda"))
    torch.cuda.synchronize()
    assert GN_ITERATIONS == 15
    assert sum(tr.counts["pnp.normal_kernel"].values()) == 15
    assert inliers.all()
    assert torch.allclose(pose.R.cpu(), torch.tensor(R[0]), atol=1e-4)
