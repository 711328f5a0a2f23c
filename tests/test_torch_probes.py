"""The SSD probes' plain versions (``tadataka_torch.probes.exp_ssd``)
against the JAX package on the CPU.

``benchmarks/exp_ssd.py`` runs its benchmark when imported, so its
kernels are held against what they compute in the JAX package: the
serial and the two-pass search against ``sweep.py::_ssd_search_xla``,
the copy floor against ``jnp.sum(V, 0)``.  The kernels themselves are
tested on the card in test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tadataka_tpu.vo.semi_dense.sweep import _ssd_search_xla

from tadataka_torch.probes.exp_ssd import (
    ssd_copy_floor, ssd_copy_floor_reference, ssd_par, ssd_par_reference,
    ssd_serial)

from tests.test_torch_kernels import SSD_CASES, ssd_case, tensors


def xla_search(V, K, mlo, mhi):
    return [np.asarray(x) for x in _ssd_search_xla(
        jnp.asarray(V), jnp.asarray(K), jnp.asarray(mlo), jnp.asarray(mhi))]


@pytest.mark.parametrize("S", [5, 32])
def test_copy_floor_matches_jnp_sum(S):
    """The left-to-right plane sum within 1e-6 relative of ``jnp.sum``
    (which may sum in another order), and the CPU wrapper returns the
    plain version's bits."""
    V = np.random.default_rng(S).random((S, 12, 40)).astype(np.float32)
    port = ssd_copy_floor(torch.from_numpy(V))
    assert torch.equal(port, ssd_copy_floor_reference(torch.from_numpy(V)))
    np.testing.assert_allclose(port.numpy(), np.asarray(jnp.sum(V, 0)),
                               rtol=1e-6)


@pytest.mark.parametrize("S, shape", [(1, (12, 40)), (1, (13, 37)),
                                      (2, (7, 9)), (5, (13, 37))])
def test_copy_floor_small_s_and_odd_sizes_match_jnp_sum(S, shape):
    """The sizes the bulk-copy floor's tests run at (one plane, fewer
    planes than ring stages) and the sizes it refuses on the card (H * W
    % 4 != 0), for the plain version: bit-equal to ``_copy_kernel``'s
    body in jnp (acc = V[0], then acc + V[s] in order, so -0.0 stays
    -0.0), and within 1e-6 relative of ``jnp.sum`` (whose +0.0 start
    turns a sum of -0.0 into +0.0)."""
    V = np.random.default_rng(S).random((S, *shape)).astype(np.float32)
    V[:, 0, :3] = -0.0
    port = ssd_copy_floor_reference(torch.from_numpy(V)).numpy()
    body = jnp.asarray(V[0])
    for s in range(1, S):
        body = body + jnp.asarray(V[s])
    assert np.array_equal(port.view(np.int32),
                          np.asarray(body).view(np.int32))
    assert np.signbit(port[0, :3]).all()
    np.testing.assert_allclose(port, np.asarray(jnp.sum(V, 0)), rtol=1e-6)


@pytest.mark.parametrize("S", [16, 32])
@pytest.mark.parametrize("case", SSD_CASES)
def test_serial_matches_xla(case, S):
    """The serial probe's plain version (``ssd_search``'s) against the
    XLA search: best equal everywhere, the errors within 1e-6."""
    arrays = ssd_case(case, S)
    best, *errs = ssd_serial(*tensors(arrays), cols_per_thread=4,
                             rows_per_block=2)
    jbest, *jerrs = xla_search(*arrays)
    np.testing.assert_array_equal(best.numpy(), jbest)
    for port, ref in zip(errs, jerrs):
        np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("S", [16, 32])
@pytest.mark.parametrize("case", SSD_CASES)
def test_par_matches_xla(case, S):
    """The two-pass probe's plain version (errors in the rsqrt form)
    against the XLA search (sqrt and divide): best equal on >= 99% of
    pixels (a window pair within an ulp may swap), and where best is
    equal the errors within 1e-5 (the two forms round differently).
    No-match pixels agree exactly: best -1 and errors 3e38."""
    arrays = ssd_case(case, S)
    best, *errs = ssd_par(*tensors(arrays))
    ref_best, *ref_errs = ssd_par_reference(*tensors(arrays))
    assert torch.equal(best, ref_best)
    jbest, *jerrs = xla_search(*arrays)
    best = best.numpy()
    same = best == jbest
    assert same.mean() >= 0.99, same.mean()
    assert np.array_equal(best == -1, jbest == -1)
    for port, ref in zip(errs, jerrs):
        np.testing.assert_allclose(port.numpy()[same], ref[same], rtol=0,
                                   atol=1e-5)


def test_probes_refuse_other_devices():
    """A wrapper runs the plain version on the CPU, launches on CUDA and
    refuses anything else."""
    args = tensors(ssd_case("planted", 16))
    meta = [x.to("meta") for x in args]
    for call in (lambda: ssd_copy_floor(meta[0]),
                 lambda: ssd_serial(*meta), lambda: ssd_par(*meta)):
        with pytest.raises(ValueError, match="no kernel for device"):
            call()
    with pytest.raises(ValueError, match="float32"):
        ssd_copy_floor(args[0].double())
