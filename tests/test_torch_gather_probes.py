"""The gather probes' plain versions (``tadataka_torch/probes/gather.py``)
against the XLA forms their JAX scripts compare with, on the CPU.

``benchmarks/test_dynamic_gather.py`` and ``test_pallas_gather.py`` run
their TPU timings when imported, so the kernels are held against what
those scripts check them with: ``jnp.take_along_axis`` (rows 5, 6 and
9, wrap and NaN), ``jnp.take(..., mode="clip")`` (row 8) and a ``jnp``
transcription of ``k_multi``'s body (row 7).  The inputs include planted
negative, out-of-range and edge indices.  Gathers move values without
arithmetic, so they are bit-equal (NaN in the same places); ``k_multi``
sums in the same order, also bit-equal.  The kernels themselves are
tested on the card in test_torch_kernels.py.
"""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tadataka_torch.probes import gather as g

from tests.test_torch_kernels import gather_case


def k_multi(img, idxr, idxc, S):
    """``benchmarks/test_dynamic_gather.py::k_multi``'s body in jnp."""
    acc = jnp.zeros(img.shape, jnp.float32)
    for s in range(S):
        t1 = jnp.take_along_axis(img, idxc, axis=1)
        t2 = jnp.take_along_axis(t1, idxr, axis=0)
        acc = acc + t2 * (1.0 + s)
    return acc


def assert_same(port, ref):
    ref = torch.from_numpy(np.array(ref))
    assert g.same_bits(port, ref)


SHAPES = [(48, 64), (37, 53)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("axis", [0, 1])
def test_take_along_axis_matches_jnp(shape, axis):
    img, rows, cols = gather_case(shape)
    idx = rows if axis == 0 else cols
    fn = g.take_along_axis0 if axis == 0 else g.take_along_axis1
    port = fn(torch.from_numpy(img), torch.from_numpy(idx))
    assert torch.isnan(port).any() and not torch.isnan(port).all()
    assert_same(port, jnp.take_along_axis(jnp.asarray(img), jnp.asarray(idx),
                                          axis=axis))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("design", ["row", "thread"])
def test_take_along_axis1_designs_match_jnp(shape, design):
    """take_along_axis1 ("row") and its first kernel ("thread"), on their
    CPU path, against ``jnp.take_along_axis(..., axis=1)``, NaN in the
    same places."""
    img, _, cols = gather_case(shape)
    call = (g.take_along_axis1 if design == "row"
            else partial(g.first_kernel, g.take_along_axis1))
    port = call(torch.from_numpy(img), torch.from_numpy(cols))
    assert torch.isnan(port).any() and not torch.isnan(port).all()
    assert_same(port, jnp.take_along_axis(jnp.asarray(img),
                                          jnp.asarray(cols), axis=1))


@pytest.mark.parametrize("S, N", [(8, 713), (13, 713), (3, 5)])
@pytest.mark.parametrize("design", ["thread", "band"])
def test_flat_take_designs_match_jnp_take_clip(design, S, N):
    """flat_take ("band") and its first kernel ("thread"), on their CPU
    path, against ``jnp.take(..., mode="clip")`` on planted negative and
    past-the-end indices, with S*N % 4 of 0, 1 and 3."""
    img, idx = gather_case((23, 31), S=S)
    idx = np.resize(idx, (S, N))
    call = (g.flat_take if design == "band"
            else partial(g.first_kernel, g.flat_take))
    port = call(torch.from_numpy(img), torch.from_numpy(idx))
    assert_same(port, jnp.take(jnp.asarray(img).ravel(), jnp.asarray(idx),
                               mode="clip"))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("S", [1, 16])
def test_multi_warp_matches_k_multi(shape, S):
    img, rows, cols = gather_case(shape)
    port = g.multi_warp(*(torch.from_numpy(x) for x in (img, rows, cols)), S)
    assert_same(port, k_multi(jnp.asarray(img), jnp.asarray(rows),
                              jnp.asarray(cols), S))


def test_multi_warp_in_range_is_finite():
    """On the script's inputs (indices in range) every pixel is finite."""
    gen = np.random.default_rng(0)
    img = gen.random((24, 32)).astype(np.float32)
    rows = gen.integers(0, 24, (24, 32)).astype(np.int32)
    cols = gen.integers(0, 32, (24, 32)).astype(np.int32)
    port = g.multi_warp(*(torch.from_numpy(x) for x in (img, rows, cols)))
    assert torch.isfinite(port).all()
    assert_same(port, k_multi(jnp.asarray(img), jnp.asarray(rows),
                              jnp.asarray(cols), 16))


@pytest.mark.parametrize("S", [8, 13])
def test_flat_take_matches_jnp_take_clip(S):
    img, idx = gather_case((23, 31), S=S)
    port = g.flat_take(torch.from_numpy(img), torch.from_numpy(idx))
    assert_same(port, jnp.take(jnp.asarray(img).ravel(), jnp.asarray(idx),
                               mode="clip"))


@pytest.mark.parametrize("S", [8, 13])
def test_flat_take_rows_matches_take_along_axis(S):
    """``kernel_taa``'s gather: take_along_axis on the flat image
    broadcast to the index rows (wrap and NaN)."""
    img, idx = gather_case((23, 31), S=S)
    port = g.flat_take_rows(torch.from_numpy(img), torch.from_numpy(idx))
    flat = jnp.asarray(img).reshape(1, -1)
    ref = jnp.take_along_axis(jnp.broadcast_to(flat, (S, flat.shape[1])),
                              jnp.asarray(idx), axis=1)
    assert torch.isnan(port).any()
    assert_same(port, ref)


@pytest.mark.parametrize("S, N", [(1, 1001), (7, 1002), (20, 1003)])
def test_flat_take_rows_odd_sizes_match_take_along_axis(S, N):
    """The sizes the card's kernels handle with a scalar tail (S * N %
    4 != 0, rows off the 16-byte grid, a single row): the CPU path
    against ``jnp.take_along_axis``, NaN in the same places."""
    img, idx = gather_case((37, 53), S=S)
    idx = np.resize(idx, (S, N))
    ref = jnp.take_along_axis(
        jnp.broadcast_to(jnp.asarray(img).reshape(1, -1), (S, img.size)),
        jnp.asarray(idx), axis=1)
    port = g.flat_take_rows(torch.from_numpy(img), torch.from_numpy(idx))
    assert torch.isnan(port).any()
    assert_same(port, ref)


def test_flat_gathers_agree_in_range():
    """On in-range indices (the script's inputs) clip and
    take_along_axis read the same values, as the script's
    ``correct=`` lines check against ``jnp.take``."""
    gen = np.random.default_rng(1)
    img = torch.from_numpy(gen.random((16, 20)).astype(np.float32))
    idx = torch.from_numpy(gen.integers(0, 320, (8, 320)).astype(np.int32))
    assert g.same_bits(g.flat_take(img, idx), g.flat_take_rows(img, idx))
