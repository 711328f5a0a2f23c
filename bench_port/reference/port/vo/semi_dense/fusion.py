"""Gaussian product fusion of inverse-depth hypotheses (counterpart of
``tadataka_tpu/vo/semi_dense/fusion.py``)."""


def fusion(mu1, mu2, var1, var2):
    v = var1 + var2
    return (mu1 * var2 + mu2 * var1) / v, (var1 * var2) / v


def fusion_maps(mu1, mu2, var1, var2):
    """Elementwise over whole maps (the same arithmetic as ``fusion``)."""
    return fusion(mu1, mu2, var1, var2)


def are_statistically_same(inv_depth1, inv_depth2, variance1, variance2,
                           factor=2.0):
    """2-sigma compatibility both ways."""
    ds = (inv_depth1 - inv_depth2) ** 2
    fs = factor * factor
    return (ds <= fs * variance1) & (ds <= fs * variance2)
