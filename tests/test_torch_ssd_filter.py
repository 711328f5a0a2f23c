"""The candidate filter of ``ssd_serial``'s "tile" kernel in plain
PyTorch (``tadataka_torch/probes/exp_ssd.py``), on the CPU.

The kernel scores every window approximately, re-scores exactly only
the windows within 3 delta of the least approximate error (2 delta, and
one more for the rounding of the cutoff), and scans every window
exactly where it cannot certify a pixel.  Its plain version
must give the bits of ``ssd_search_reference``, also when the
approximation is moved adversarially by up to delta; and delta must
bound the approximation of the kernel's pass 1 (a fused sum, a root
with the card's error of at most 2^-20 and no division).  The card tests
(``tests/test_torch_kernels.py``, marked ``cuda``) hold the kernel to
this plain version and to ``ssd_search``.
"""

import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tadataka_torch.probes import exp_ssd as probes
from tadataka_torch.vo.semi_dense.sweep import (
    _window_errors, ssd_search_reference)
from tests.test_torch_kernels import (
    FILTER_CASES, SSD_CASES, ssd_case, tensors)

DELTA = probes.FILTER_DELTA
U = 2.0 ** -24


def within_delta(e, p):
    """e + p (|p| <= DELTA) rounded to float32, stepped back toward e
    where the rounding took it past DELTA."""
    a = (e.double() + p).float()
    over = (a.double() - e.double()).abs() > DELTA
    return torch.where(over, torch.nextafter(a, e), a)


def finite_key(K):
    return ~torch.isnan(K).any(0)


def assert_same(out, ref):
    """Equal outputs, NaN in the same places."""
    for a, b in zip(out, ref):
        assert torch.equal(a.isnan(), b.isnan())
        assert torch.equal(torch.where(a.isnan(), 0, a),
                           torch.where(b.isnan(), 0, b))


@pytest.mark.parametrize("S", [16, 48])
@pytest.mark.parametrize("case", SSD_CASES + FILTER_CASES)
def test_filter_gives_the_exact_search(case, S):
    """The filter's outputs are ssd_search_reference's bits, NaN in the
    same places: also on a pixel with NaN in its key, which the filter
    sends to the exact scan, where the Pallas kernel's rule leaves it no
    best, 3e38 and window 0's NaN error.  A pixel with one candidate
    scores at most 3 windows exactly; a tied one sweeps again and scores
    a few."""
    args = tensors(ssd_case(case, S))
    out, (n_exact, n_scan, n_sweep) = probes.ssd_serial_filter_reference(
        *args)
    ref = ssd_search_reference(*args)
    assert_same(out, ref)
    if case == "nan_key":
        nan = ~finite_key(args[1])
        assert nan.any()
        assert (out[0][nan] == -1).all()
        assert (out[1][nan] == 3e38).all() and (out[2][nan] == 3e38).all()
        assert torch.isnan(out[3][nan]).all()
    H, W = args[2].shape
    assert 0 <= n_scan + n_sweep <= H * W
    if case in ("planted", "invalid_samples"):
        assert n_scan == n_sweep == 0 and n_exact <= 3 * H * W
    if case in ("ties", "near_tie"):
        assert n_scan == 0 and n_sweep == H * W   # a second candidate
    if case == "near_tie":
        assert n_exact < 6 * H * W
    if case == "nan_key":
        assert n_scan == (~finite_key(args[1])).sum()


@pytest.mark.parametrize("mode", ["min_up", "random"])
@pytest.mark.parametrize("case", SSD_CASES + ["near_tie", "tiny_wn2"])
def test_filter_survives_an_adversarial_approximation(case, mode):
    """The approximation replaced by the exact errors moved by up to
    delta: "min_up" raises every window that reaches the pixel's exact
    minimum by delta and lowers every other by delta (on "near_tie" the
    approximate order of the two windows one ulp apart is the reverse of
    the exact one), "random" moves each window uniformly in [-delta,
    delta].  The outputs stay ssd_search_reference's bits."""
    S = 16
    args = tensors(ssd_case(case, S))
    e = _window_errors(*args)
    if mode == "min_up":
        low = torch.where(e < 3e38, e, np.inf).min(0).values
        p = torch.where(e == low, DELTA, -DELTA).double()
    else:
        gen = torch.Generator().manual_seed(5)
        p = (torch.rand(e.shape, generator=gen, dtype=torch.float64) * 2
             - 1) * DELTA
    approx = within_delta(e, p)
    assert ((approx.double() - e.double()).abs() <= DELTA).all()
    if case == "near_tie":
        a, b = approx[2], approx[9]
        assert ((e[2] < e[9]) & (a > b)).any() or mode == "random"
    out, _ = probes.ssd_serial_filter_reference(*args, approx=approx)
    assert_same(out, ssd_search_reference(*args))


@pytest.mark.parametrize("rho", [-2.0 ** -20, 0.0, 2.0 ** -20])
@pytest.mark.parametrize("inputs", ["unit", "wide"])
def test_delta_bounds_the_approximation(inputs, rho):
    """On every window the filter certifies, |a - e| <= 73.2 u (the bound
    derived in csrc/ssd_probes.cu) <= delta, with the card's rsqrt.approx
    stood in for by an exact root off by a relative rho of up to 2^-20:
    samples and keys uniform in [0, 1), and ("wide") scaled by powers of
    two from 2^-40 to 2^40, so that wn2 and K span 160 binades."""
    gen = np.random.default_rng(3)
    S, H, W = 24, 32, 64
    V = gen.random((S, H, W)).astype(np.float32)
    K = gen.random((5, H, W)).astype(np.float32)
    if inputs == "wide":
        V = (V * 2.0 ** gen.integers(-40, 41, (S, H, W))).astype(np.float32)
        K = (K * 2.0 ** gen.integers(-40, 41, (5, H, W))).astype(np.float32)
    V, K = torch.from_numpy(V), torch.from_numpy(K)
    mlo, mhi = torch.zeros(H, W), torch.full((H, W), float(S - 5))
    e = _window_errors(V, K, mlo, mhi)
    a, wn2, kn = probes.filter_approx_errors(V, K, rho)
    tk = torch.full_like(kn, 2.0 ** -28) / kn
    certified = ((wn2 > tk * tk) & (wn2 >= 2.0 ** -126)
                 & (wn2 <= torch.finfo(torch.float32).max)
                 & (kn >= 2.0 ** -60) & (kn <= 2.0 ** 60))
    assert certified.float().mean().item() > 0.5
    worst = (a.double() - e.double()).abs()[certified].max().item()
    assert worst <= 73.2 * U <= DELTA
    assert a[certified].abs().max().item() < 4.1
    if rho == 0.0:
        assert worst <= 16 * U


def test_delta_is_the_kernels():
    """FILTER_DELTA is the kernel source's kFilterDelta."""
    source = (Path(probes.__file__).parent / "csrc" /
              "ssd_probes.cu").read_text()
    value = re.search(r"kFilterDelta = (0x1p-\d+)f;", source).group(1)
    assert float.fromhex(value) == DELTA


def test_tile_designs_on_cpu():
    """Neither ssd_serial nor ssd_par takes a design.  On CPU tensors
    ssd_serial runs the plain filter where the card runs "tile" (S up to
    SERIAL_TILE_MAX_S, H * W % 4 == 0) and ssd_search_reference where it
    runs "thread", and ssd_par the plain two-pass search (a pixel with a
    NaN error gets ``_par_kernel``'s bm = M and ec = NaN); neither counts
    a launch, ``rescore`` gains the filter's counts, and a bad
    ``rescore`` (or one given where "thread" runs) and a shape "tile"
    refuses raise; the census counts what the filter does."""
    for fn in (probes.ssd_serial, probes.ssd_par):
        assert "design" not in inspect.signature(fn).parameters
    args = tensors(ssd_case("nan_key", 16))
    counts = [probes.ssd_serial.launches, probes.ssd_par.launches]
    rescore = torch.zeros(3, dtype=torch.int64)
    out = probes.ssd_serial(*args, rescore=rescore)
    plain, n = probes.ssd_serial_filter_reference(*args)
    assert_same(out, plain)
    assert rescore.tolist() == list(n)
    par = probes.ssd_par(*args)
    assert_same(par, probes.ssd_par_reference(*args))
    nan = torch.isnan(args[1]).any(0)
    assert torch.isnan(par[1][nan]).all() and (par[0][nan] == 12).all()
    assert counts == [probes.ssd_serial.launches, probes.ssd_par.launches]
    assert [probes.serial_design(S) for S in (
        5, probes.SERIAL_TILE_MAX_S, probes.SERIAL_TILE_MAX_S + 1)] == [
            "tile", "tile", "thread"]
    odd = [x[..., :7, :63].contiguous() for x in args]   # H * W % 4 == 1
    assert_same(probes.ssd_serial(*odd), ssd_search_reference(*odd))
    with pytest.raises(ValueError, match="rescore"):
        probes.ssd_serial(*odd, rescore=rescore)
    with pytest.raises(ValueError, match="rescore"):
        probes.ssd_serial(*args, rescore=rescore.int())
    with pytest.raises(ValueError, match="H \\* W % 4"):
        probes.tile_config(16, 13, 37, serial=True)
    census = probes.filter_census(*args)
    assert census["scan"] == n[1] and census["several"] == n[2]
    assert census["windows"] >= census["scan"] + census["one"] + census[
        "several"]
