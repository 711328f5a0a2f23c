"""Per-pixel result flags (counterpart of ``tadataka_tpu/flags.py``).

A flag map is an int32 tensor; consumers mask on ``flag == SUCCESS``.
"""

from enum import IntEnum


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

