"""Every SSD form of the port against its own Pallas kernel on window
errors that are NaN, on the CPU.

The two Pallas kernels place a NaN error differently:

- ``_ssd_kernel`` (tadataka_tpu/vo/semi_dense/sweep.py, run by
  ``ssd_search`` on the TPU; ``benchmarks/exp_ssd.py::_serial_kernel``
  has the same body) keeps its running minimum with ``jnp.minimum``,
  which turns NaN at the first NaN error, so no later window becomes the
  best; a pixel with no best keeps en = window 0's error.  ``ssd_search``
  and ``ssd_serial`` (both kernels) follow it.
- ``_par_kernel`` (benchmarks/exp_ssd.py) takes the minimum over all
  windows, NaN as soon as one error is NaN; no window equals it, so the
  pixel gets bm = M, ec = NaN, ep = the last window's error, en = 3e38.
  ``ssd_par`` follows it.

Both kernels run here through ``pl.pallas_call(..., interpret=True)``
with block specs that name no memory space, in a child process (see
:func:`pallas_outputs`), on every case at once.  ``benchmarks/exp_ssd.py``
runs its 480x640 benchmark when imported, so ``_par_kernel``'s source is
taken from the file with ``ast`` and run on its own.  NaN errors come
from a NaN key sample, an infinite sample or squares that overflow.
The card tests (``tests/test_torch_kernels.py``, marked ``cuda``) hold
the kernels to these plain versions.
"""

import ast
import functools
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tadataka_tpu.vo.semi_dense import sweep as jsweep

from tadataka_torch.probes import exp_ssd as probes
from tadataka_torch.vo.semi_dense.sweep import (
    _serial_scan, ssd_search, ssd_search_reference)

from tests.test_torch_kernels import NAN_CASES, nan_case

S, H, W = 16, 8, 16
M = S - 4
EXP_SSD = Path(__file__).resolve().parent.parent / "benchmarks" / "exp_ssd.py"

def par_kernel():
    """``_par_kernel``'s source, compiled without running exp_ssd.py (it
    reads the globals Kw and M, given at each call)."""
    tree = ast.parse(EXP_SSD.read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "_par_kernel")
    return compile(ast.Module(body=[fn], type_ignores=[]), str(EXP_SSD),
                   "exec")


def run_pallas(path):
    """Run both Pallas kernels in interpret mode on every case at once
    (the cases side by side along W: pixels are independent) and save
    their outputs to ``path`` (.npz, "ssd" and "par", each (4, H, W x
    cases)).  Called in a child process by :func:`pallas_outputs`."""
    inputs = [np.concatenate(x, axis=-1) for x in zip(
        *(nan_case(case) for case in NAN_CASES))]
    width = inputs[0].shape[-1]
    specs = ([pl.BlockSpec((S, H, width), lambda i: (0, 0, 0)),
              pl.BlockSpec((5, H, width), lambda i: (0, 0, 0))]
             + [pl.BlockSpec((H, width), lambda i: (0, 0))] * 2)
    common = dict(
        out_shape=[jax.ShapeDtypeStruct((H, width), jnp.float32)] * 4,
        grid=(1,), in_specs=specs,
        out_specs=[pl.BlockSpec((H, width), lambda i: (0, 0))] * 4,
        interpret=True)
    scope = dict(jax=jax, jnp=jnp, EPSILON=1e-16, _INF=3.0e38, Kw=5, M=M)
    exec(par_kernel(), scope)
    args = [jnp.asarray(x) for x in inputs]
    ssd = pl.pallas_call(jsweep._ssd_kernel, **common)(*args)
    par = pl.pallas_call(
        scope["_par_kernel"],
        scratch_shapes=[pltpu.VMEM((M, H, width), jnp.float32)],
        **common)(*args)
    np.savez(path, ssd=np.stack(ssd), par=np.stack(par))


@functools.lru_cache(maxsize=None)
def pallas_outputs():
    """{"ssd": ..., "par": ...}: each kernel's (best, ec, ep, en) of
    every case, {case: [4 arrays (H, W)]}.

    The kernels run in a child process whose XLA compiles for SSE4.2:
    where the host has FMA instructions, XLA's CPU compiler contracts a
    product and a sum into one fused multiply-add (one rounding where
    the kernel's source asks for two); without them it rounds every
    operation as written, as the port does."""
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=SSE4_2",
               PYTHONPATH=os.pathsep.join(
                   [str(root)] + os.environ.get("PYTHONPATH", "").split(
                       os.pathsep)).rstrip(os.pathsep))
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "pallas.npz"
        subprocess.run(
            [sys.executable, "-c", "import sys; from tests.test_torch_ssd_nan"
             " import run_pallas; run_pallas(sys.argv[1])", str(path)],
            env=env, cwd=root, check=True, timeout=300)
        saved = np.load(path)
        return {kernel: {case: list(saved[kernel][..., i * W:(i + 1) * W])
                         for i, case in enumerate(NAN_CASES)}
                for kernel in ("ssd", "par")}


def assert_same_bits(port, pallas, what):
    """The port's (best, ec, ep, en) against a Pallas kernel's (best as
    float): equal, NaN in the same places."""
    best, *errs = port
    assert np.array_equal(best.numpy(), pallas[0].astype(np.int32)), what
    for name, a, b in zip(("ec", "ep", "en"), errs, pallas[1:]):
        a = a.numpy()
        nan = np.isnan(a)
        assert np.array_equal(nan, np.isnan(b)), (what, name)
        assert np.array_equal(a[~nan].view(np.int32),
                              b[~nan].view(np.int32)), (what, name)


def tensors(case):
    return [torch.from_numpy(x) for x in nan_case(case)]


@pytest.mark.parametrize("case", NAN_CASES)
def test_serial_forms_follow_ssd_kernel(case):
    """ssd_search on the CPU, ssd_serial_reference, the plain candidate
    filter of ssd_serial's "tile" kernel and ssd_serial on the CPU give
    ``_ssd_kernel``'s bits; the case holds NaN errors where it says and
    pixels with a best."""
    pallas = pallas_outputs()["ssd"][case]
    args = tensors(case)
    assert_same_bits(ssd_search(*args), pallas, "ssd_search")
    assert_same_bits(probes.ssd_serial_reference(*args), pallas,
                     "ssd_serial_reference")
    assert_same_bits(probes.ssd_serial_filter_reference(*args)[0], pallas,
                     "ssd_serial_filter_reference")
    assert_same_bits(probes.ssd_serial(*args), pallas, "ssd_serial")
    assert (pallas[0] >= 0).any()
    if case in ("nan_after_best", "nan_window0", "nan_key_rows",
                "overflow"):
        assert np.isnan(pallas[3]).any()
    if case in ("nan_first_in_bounds", "nan_window0", "nan_key_rows"):
        assert (pallas[0] < 0).any()


@pytest.mark.parametrize("case", NAN_CASES)
def test_par_follows_par_kernel(case):
    """ssd_par_reference and ssd_par on the CPU give
    ``_par_kernel``'s bits: bm = M, ec NaN, ep the last window's error
    and en 3e38 on every pixel with a NaN error."""
    pallas = pallas_outputs()["par"][case]
    args = tensors(case)
    assert_same_bits(probes.ssd_par_reference(*args), pallas,
                     "ssd_par_reference")
    assert_same_bits(probes.ssd_par(*args), pallas, "ssd_par")
    nan = np.isnan(pallas[1])
    assert nan.any() and (pallas[0][nan] == M).all()
    assert (pallas[3][nan] == np.float32(3e38)).all()


def pallas_scan(errs):
    """``_ssd_kernel``'s update, window by window, in numpy float32 on
    the errors of one pixel."""
    inf = np.float32(3e38)
    best, bm, ec, ep, en, prev = inf, -1, inf, inf, inf, inf
    for m, err in enumerate(errs):
        if m == bm + 1:
            en = err
        if err < best:
            ep, en, ec, bm = prev, inf, err, m
        best = np.minimum(best, err)
        prev = err
    return bm, ec, ep, en


def test_closed_form_scan_is_the_kernels_scan():
    """_serial_scan, the closed form of the Pallas scan, on errors mixing
    NaN, 3e38, +inf, ties and finite values: the scan's outputs at every
    pixel."""
    gen = np.random.default_rng(4)
    errs = gen.choice(np.array([0.25, 0.5, 0.5, 1.0, 3e38, np.inf, np.nan],
                               np.float32), size=(6, 40, 50),
                      p=[0.2, 0.2, 0.1, 0.2, 0.15, 0.05, 0.1])
    out = [x.numpy() for x in _serial_scan(torch.from_numpy(errs))]
    for i in range(errs.shape[1]):
        for j in range(errs.shape[2]):
            want = pallas_scan(errs[:, i, j])
            got = [x[i, j] for x in out]
            assert got[0] == want[0]
            for a, b in zip(got[1:], want[1:]):
                assert (np.isnan(a) and np.isnan(b)) or a == b, (i, j)


def test_nan_free_inputs_keep_the_xla_search():
    """Without a NaN error the plain search is still the XLA search's
    first-index argmin: best equal, the errors within 1e-6 (the XLA
    form's rounding), on "nan_after_best"'s rows that hold no infinity."""
    V, K, mlo, mhi = nan_case("nan_after_best")
    rows = slice(4, H)
    args = [np.ascontiguousarray(x[..., rows, :]) for x in (V, K)] + [
        np.ascontiguousarray(x[rows]) for x in (mlo, mhi)]
    port = ssd_search_reference(*(torch.from_numpy(x) for x in args))
    xla = [np.asarray(x) for x in jsweep._ssd_search_xla(
        *(jnp.asarray(x) for x in args))]
    assert np.array_equal(port[0].numpy(), xla[0])
    for a, b in zip(port[1:], xla[1:]):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6)
