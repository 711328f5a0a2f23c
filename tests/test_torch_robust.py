"""Parity of the port's robust weights (``tadataka_torch/robust/
weights.py``) with the JAX package on the CPU, on seeded numpy
residuals with and without masks.

The median and the Tukey/Huber weights are elementwise or a sort, so
they agree within 1 ulp of float32 (rtol 1e-6; the JAX side may fuse or
reorder a product).  Student-t runs ten variance iterations whose sums
are taken in another order than ``jnp.sum``: rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tadataka_tpu.robust import weights as jw

from tadataka_torch.robust import weights as tw

N = 1001


def residuals(case, seed=3):
    """(r, mask) of one case: 'plain' (normal residuals, all valid),
    'masked' (a third masked), 'ties' (repeated values around the median,
    an even valid count), 'outliers' (heavy tails past every threshold),
    'few' (three valid lanes) and 'none_valid'."""
    gen = np.random.default_rng(seed)
    r = gen.normal(scale=0.1, size=N).astype(np.float32)
    mask = np.ones(N, bool)
    if case == "masked":
        mask = gen.random(N) > 0.33
    elif case == "ties":
        r = np.round(r * 20).astype(np.float32) / 20
        mask[0] = False                           # an even valid count
    elif case == "outliers":
        r[gen.random(N) < 0.1] *= 80.0
    elif case == "few":
        mask[:] = False
        mask[[3, 500, 900]] = True
    elif case == "none_valid":
        mask[:] = False
    return r, mask


CASES = ["plain", "masked", "ties", "outliers", "few", "none_valid"]


def both(fn, r, mask, **kw):
    port = getattr(tw, fn)(torch.from_numpy(r), mask=torch.from_numpy(mask),
                           **kw).numpy()
    ref = np.asarray(getattr(jw, fn)(jnp.asarray(r), mask=jnp.asarray(mask),
                                     **kw))
    return port, ref


@pytest.mark.parametrize("case", CASES)
def test_masked_median_and_mad(case):
    """The sort-based masked median (the mean of the two middle valid
    values) and the MAD, equal to the JAX package's bit for bit, also on
    ties and an even count (where ``torch.median`` would return the lower
    middle value)."""
    r, mask = residuals(case)
    for port, ref in (
            (tw._masked_median(torch.from_numpy(r), torch.from_numpy(mask)),
             jw._masked_median(jnp.asarray(r), jnp.asarray(mask))),
            (tw.median_absolute_deviation(torch.from_numpy(r),
                                          torch.from_numpy(mask)),
             jw.median_absolute_deviation(jnp.asarray(r),
                                          jnp.asarray(mask)))):
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    if case == "ties":
        valid = np.sort(r[mask])
        assert valid.size % 2 == 0
        expect = np.float32(0.5) * (valid[valid.size // 2 - 1]
                                    + valid[valid.size // 2])
        assert tw._masked_median(torch.from_numpy(r),
                                 torch.from_numpy(mask)).item() == expect


def test_mad_without_mask():
    r, _ = residuals("plain")
    np.testing.assert_array_equal(
        tw.median_absolute_deviation(torch.from_numpy(r)).numpy(),
        np.asarray(jw.median_absolute_deviation(jnp.asarray(r))))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("fn", ["compute_weights_tukey",
                                "compute_weights_huber",
                                "compute_weights_student_t"])
def test_weights(fn, case):
    """Each weight function against JAX's: rtol 1e-6 (Tukey, Huber) or
    1e-5 (Student-t, summed in another order), zero on masked lanes."""
    r, mask = residuals(case)
    port, ref = both(fn, r, mask)
    rtol = 1e-5 if fn == "compute_weights_student_t" else 1e-6
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=1e-7)
    assert np.all(port[~mask] == 0.0)


@pytest.mark.parametrize("beta", [1.0, 4.6851])
def test_tukey(beta):
    x = np.linspace(-6.0, 6.0, 241).astype(np.float32)
    np.testing.assert_allclose(tw.tukey(torch.from_numpy(x), beta).numpy(),
                               np.asarray(jw.tukey(jnp.asarray(x), beta)),
                               rtol=1e-6, atol=1e-7)


def test_weights_without_mask():
    """The default mask (all valid) gives the JAX weights."""
    r, _ = residuals("outliers")
    for fn in ("compute_weights_tukey", "compute_weights_huber",
               "compute_weights_student_t"):
        np.testing.assert_allclose(
            getattr(tw, fn)(torch.from_numpy(r)).numpy(),
            np.asarray(getattr(jw, fn)(jnp.asarray(r))), rtol=1e-5,
            atol=1e-7)
