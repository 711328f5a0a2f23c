"""Per-pixel result flags (counterpart of ``tadataka_tpu/flags.py``).

A flag map is an int32 tensor; consumers mask on ``flag == SUCCESS``.
"""

from enum import IntEnum

import torch


class Flag(IntEnum):
    SUCCESS = 0
    HYPOTHESIS_OUT_OF_SEARCH_RANGE = -1
    KEY_OUT_OF_RANGE = -2
    REF_CLOSE_OUT_OF_RANGE = -3
    REF_FAR_OUT_OF_RANGE = -4
    REF_EPIPOLAR_TOO_SHORT = -5
    INSUFFICIENT_GRADIENT = -6
    NEGATIVE_PRIOR_DEPTH = -7
    NEGATIVE_REF_DEPTH = -8
    NOT_PROCESSED = -9



def success_mask(flag_map):
    """Boolean mask of the lanes that completed successfully."""
    return flag_map == int(Flag.SUCCESS)


def flag_histogram(flag_map):
    """Count of each flag value, (n_flags,) int64 indexed by -flag: index
    0 counts SUCCESS, index k counts flag value -k."""
    idx = -flag_map.to(torch.int64).reshape(-1)
    return torch.zeros(len(Flag), dtype=torch.int64,
                       device=flag_map.device).index_add_(
        0, idx, torch.ones_like(idx))
