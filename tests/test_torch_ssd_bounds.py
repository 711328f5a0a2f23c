"""The SSD search's window bounds and the invariant the ring kernel of
``ssd_search`` relies on, on the CPU.

``ssd_window_bounds(mlo, mhi, S)`` turns each pixel's float bounds into
the integer window range [m_lo, m_hi] that the ring kernel searches; it
is held against a brute-force check of every window.  The ring kernel
reads only planes m_lo .. m_hi + 4 of each pixel (none for an empty
range), so the outputs of both plain versions, the port's
``ssd_search_reference`` and the JAX package's ``_ssd_search_xla``, must
not change, bit for bit, when every other plane is overwritten.
Inputs come from seeded numpy generators.
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tadataka_tpu.vo.semi_dense.sweep import _ssd_search_xla

from tadataka_torch.vo.semi_dense.sweep import (
    ssd_search, ssd_search_reference, ssd_window_bounds)

SHAPE = (6, 11)


def special_bounds(M):
    """Bounds the main path gives (the 1e9 / -1e9 sentinels, fractional
    ceil/floor results) and the edge cases: NaN, +-inf, -0.0, below 0,
    past M - 1."""
    return np.array([np.nan, np.inf, -np.inf, 1e9, -1e9, -3.5, -1.0, -0.0,
                     0.0, 0.25, 1.0, 2.5, M - 1.5, M - 1.0, M - 0.75, M,
                     M + 3.25, 300.0], np.float32)


def bounds_case(S, shape, seed):
    """(mlo, mhi) float32: a third special values, a third fractional in
    [-3, M + 3] (mlo > mhi on some), a third narrow ranges."""
    gen = np.random.default_rng(seed)
    M = S - 4
    specials = special_bounds(M)
    n = int(np.prod(shape))
    which = gen.integers(0, 3, n)
    mlo = gen.uniform(-3.0, M + 3.0, n).astype(np.float32)
    mhi = gen.uniform(-3.0, M + 3.0, n).astype(np.float32)
    mlo[which == 0] = specials[gen.integers(0, len(specials),
                                            (which == 0).sum())]
    mhi[which == 0] = specials[gen.integers(0, len(specials),
                                            (which == 0).sum())]
    narrow = which == 2
    mlo[narrow] = np.floor(mlo[narrow])
    mhi[narrow] = mlo[narrow] + gen.integers(0, 4, narrow.sum())
    return mlo.reshape(shape), mhi.reshape(shape)


def search_case(S, seed):
    """(V, K, mlo, mhi) float32 numpy: V with 15% invalid samples, K
    planted at a per-pixel window inside most pixels' ranges, a constant
    column where every window ties, bounds from :func:`bounds_case`."""
    gen = np.random.default_rng(seed)
    H, W = SHAPE
    M = S - 4
    V = gen.random((S, H, W)).astype(np.float32)
    V[gen.random(V.shape) < 0.15] = -1.0
    K = gen.random((5, H, W)).astype(np.float32)
    mlo, mhi = bounds_case(S, SHAPE, seed + 1)
    at = gen.integers(0, M, (H, W))
    for y in range(H):
        for x in range(W):
            V[at[y, x]:at[y, x] + 5, y, x] = K[:, y, x]
    V[:, :, 0] = 0.5
    K[:, :, 0] = 0.5
    return V, K, mlo, mhi


@pytest.mark.parametrize("S", [5, 6, 7, 9, 48])
def test_window_bounds_match_every_window(S):
    """A window m is in [m_lo, m_hi] exactly where m >= mlo and m <= mhi
    hold in float32; m_lo lies in [0, M], m_hi in [-1, M - 1], and NaN in
    either bound gives (M, -1)."""
    M = S - 4
    mlo, mhi = bounds_case(S, (40, 50), seed=S)
    m_lo, m_hi = (x.numpy() for x in ssd_window_bounds(
        torch.from_numpy(mlo), torch.from_numpy(mhi), S))
    assert m_lo.dtype == np.int32 and m_hi.dtype == np.int32
    m = np.arange(M)[:, None, None]
    allowed = ((m.astype(np.float32) >= mlo[None])
               & (m.astype(np.float32) <= mhi[None]))
    ours = (m >= m_lo[None]) & (m <= m_hi[None])
    np.testing.assert_array_equal(ours, allowed)
    assert m_lo.min() >= 0 and m_lo.max() <= M
    assert m_hi.min() >= -1 and m_hi.max() <= M - 1
    nan = np.isnan(mlo) | np.isnan(mhi)
    assert nan.any()
    assert np.all(m_lo[nan] == M) and np.all(m_hi[nan] == -1)
    assert (m_lo > m_hi).any() and (m_lo <= m_hi).any()


def overwrite_outside(V, m_lo, m_hi, fill, seed):
    """V with every plane outside each pixel's [m_lo, m_hi + 4] (every
    plane of a pixel with an empty range) replaced by ``fill``."""
    S = V.shape[0]
    s = np.arange(S)[:, None, None]
    needed = (s >= m_lo[None]) & (s <= m_hi[None] + 4) & (m_lo <= m_hi)[None]
    values = {"minus_one": np.float32(-1.0), "nan": np.float32(np.nan),
              "huge": np.float32(3e38),
              "random": np.random.default_rng(seed).uniform(
                  -2.0, 2.0, V.shape).astype(np.float32)}[fill]
    return np.where(needed, V, values).astype(np.float32), needed


def jax_search(V, K, mlo, mhi):
    return [np.asarray(x) for x in _ssd_search_xla(
        jnp.asarray(V), jnp.asarray(K), jnp.asarray(mlo), jnp.asarray(mhi))]


@pytest.mark.parametrize("fill", ["minus_one", "nan", "huge", "random"])
@pytest.mark.parametrize("S", [5, 9, 24])
def test_outputs_depend_only_on_planes_in_bounds(S, fill):
    """Both plain versions give the same four outputs, bit for bit, after
    every plane outside each pixel's [m_lo, m_hi + 4] is overwritten with
    -1, NaN, 3e38 or random values."""
    V, K, mlo, mhi = search_case(S, seed=100 + S)
    m_lo, m_hi = (x.numpy() for x in ssd_window_bounds(
        torch.from_numpy(mlo), torch.from_numpy(mhi), S))
    V2, needed = overwrite_outside(V, m_lo, m_hi, fill, seed=S)
    assert not needed.all()
    ref = [x.numpy() for x in ssd_search_reference(
        *(torch.from_numpy(a) for a in (V, K, mlo, mhi)))]
    ref2 = [x.numpy() for x in ssd_search_reference(
        *(torch.from_numpy(a) for a in (V2, K, mlo, mhi)))]
    jref, jref2 = jax_search(V, K, mlo, mhi), jax_search(V2, K, mlo, mhi)
    for a, b in zip(ref, ref2):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    for a, b in zip(jref, jref2):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    np.testing.assert_array_equal(ref[0], jref[0])
    assert (ref[0] >= 0).any() and (ref[0] < 0).any()


def test_ssd_search_designs_on_cpu():
    """ssd_search takes no design (its launcher picks the kernel from the
    input); on CPU tensors it returns the plain version's bits and counts
    no launch."""
    assert list(inspect.signature(ssd_search).parameters) == [
        "V", "K", "mlo", "mhi"]
    V, K, mlo, mhi = (torch.from_numpy(a) for a in search_case(9, seed=3))
    before = ssd_search.launches
    ref = ssd_search_reference(V, K, mlo, mhi)
    for out, plain in zip(ssd_search(V, K, mlo, mhi), ref):
        assert torch.equal(out, plain)
    assert ssd_search.launches == before
    with pytest.raises(TypeError):
        ssd_search(V, K, mlo, mhi, design="thread")
