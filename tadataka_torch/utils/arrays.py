"""Small array helpers (counterpart of ``tadataka_tpu/utils/arrays.py``).

Parity surface: the reference tadataka's ``utils.py`` -- index
complements, dict helpers, descriptor corruption for matcher robustness
tests.  Plain numpy, as in the JAX package.
"""

import numpy as np


def random_binary(size, rng=None):
    rng = rng or np.random.default_rng()
    return rng.integers(0, 2, size).astype(bool)


def indices_other_than(size, indices):
    return np.setxor1d(indices, np.arange(size))


def merge_dicts(*dicts):
    merged = {}
    for d in dicts:
        merged.update(d)
    return merged


def round_int(X):
    return np.round(X, 0).astype(np.int64)


def value_list(dict_, keys):
    return [dict_[k] for k in keys]


def radian_to_degree(radian):
    return radian / np.pi * 180


def add_noise(descriptors, indices, rng=None):
    """Replace the given descriptor rows with random bits (for matcher
    robustness tests)."""
    descriptors = np.copy(np.asarray(descriptors))
    noise = random_binary((len(indices), descriptors.shape[1]), rng)
    if descriptors.dtype.kind == 'f':
        # +-1 float codes
        descriptors[np.asarray(indices)] = np.where(noise, 1.0, -1.0)
    else:
        descriptors[np.asarray(indices)] = noise
    return descriptors


def break_other_than(descriptors, indices, rng=None):
    keep = np.asarray(indices)
    to_break = np.setxor1d(np.arange(len(descriptors)), keep)
    return add_noise(descriptors, to_break, rng)
