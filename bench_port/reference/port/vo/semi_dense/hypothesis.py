"""Inverse-depth hypothesis range and validity (counterpart of
``tadataka_tpu/vo/semi_dense/hypothesis.py``)."""

import torch

from bench_port.reference.port.flags import Flag

VARIANCE_FACTOR = 2.0


def hypothesis_range(inv_depth, variance):
    return (inv_depth - VARIANCE_FACTOR * variance,
            inv_depth + VARIANCE_FACTOR * variance)


def clamped_range(inv_depth, variance, min_inv_depth, max_inv_depth):
    lo, hi = hypothesis_range(inv_depth, variance)
    return (torch.clamp(lo, min_inv_depth, max_inv_depth),
            torch.clamp(hi, min_inv_depth, max_inv_depth))


def check_args_flag(inv_depth, variance, min_inv_depth, max_inv_depth):
    """0 where the hypothesis is valid, else its failure flag (int32)."""
    lo, hi = hypothesis_range(inv_depth, variance)
    out_of_range = (hi <= min_inv_depth) | (max_inv_depth <= lo)
    flag = torch.where(
        out_of_range, int(Flag.HYPOTHESIS_OUT_OF_SEARCH_RANGE),
        int(Flag.SUCCESS)).to(torch.int32)
    return torch.where(inv_depth <= 0.0, int(Flag.NEGATIVE_PRIOR_DEPTH),
                       flag)
