"""BRIEF binary descriptors as +-1 float vectors (counterpart of
``tadataka_tpu/features/brief.py``): for D-bit codes a, b in {-1, +1}^D
the Hamming distance is (D - a.b) / 2, one matrix product.  The sampling
pattern is the JAX package's, drawn from ``np.random.default_rng(1)``."""

from functools import lru_cache

import numpy as np
import torch

from tadataka_torch.device import constant

from tadataka_torch.features.detector import (
    Features, detect_fast, separable_blur)

DESCRIPTOR_SIZE = 512
PATCH_SIZE = 64


@lru_cache(maxsize=None)
def _uniform_pattern(descriptor_size=DESCRIPTOR_SIZE, patch_size=PATCH_SIZE,
                     seed=1):
    """Fixed uniform sampling pattern: pairs drawn uniformly from the patch
    (skimage BRIEF's "uniform" mode).  Host int32 arrays."""
    rng = np.random.default_rng(seed)
    half = patch_size // 2
    pos0 = rng.integers(-(half - 2), half - 1, (descriptor_size, 2))
    pos1 = rng.integers(-(half - 2), half - 1, (descriptor_size, 2))
    return pos0.astype(np.int32), pos1.astype(np.int32)


@lru_cache(maxsize=None)
def _smoothing_taps(sigma=1.0, radius=2):
    """The 5 normalized Gaussian taps of ``_smooth``, float32 on the host
    (the same float32 operations as the JAX package's)."""
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    g = np.exp(np.float32(-0.5) * (x / np.float32(sigma)) ** 2)
    return g / np.sum(g)


def _smooth(image, sigma=1.0):
    """5-tap Gaussian blur along rows, then columns, zero edges."""
    return separable_blur(image, _smoothing_taps(sigma))


def brief_descriptors(image, keypoints, mask, patch_size=PATCH_SIZE,
                      descriptor_size=DESCRIPTOR_SIZE):
    """+-1 descriptors at the rounded keypoint locations (K, 2) [x, y].
    Keypoints whose patch leaves the image are masked out.  Returns
    (descriptors (K, D), valid (K,))."""
    H, W = image.shape
    smoothed = _smooth(image)
    half = patch_size // 2
    pos0, pos1 = (constant(p, image.device)
                  for p in _uniform_pattern(descriptor_size, patch_size))

    kx = torch.round(keypoints[:, 0]).to(torch.int32)
    ky = torch.round(keypoints[:, 1]).to(torch.int32)
    inside = (kx >= half) & (kx < W - half) & (ky >= half) & (ky < H - half)
    valid = mask & inside

    def sample(pos):
        xs = torch.clamp(kx[:, None] + pos[None, :, 0], 0, W - 1)
        ys = torch.clamp(ky[:, None] + pos[None, :, 1], 0, H - 1)
        return smoothed[ys.long(), xs.long()]

    bits = torch.where(sample(pos0) < sample(pos1), 1.0, -1.0)
    return bits.float(), valid


def extract_features(image, max_keypoints=512, threshold=50.0 / 255.0,
                     patch_size=PATCH_SIZE):
    """FAST + BRIEF.  ``patch_size`` must fit inside the frame for a
    keypoint to keep its descriptor; small images need a smaller one."""
    feats = detect_fast(image, threshold, max_keypoints)
    descriptors, valid = brief_descriptors(image, feats.keypoints, feats.mask,
                                           patch_size)
    return Features(feats.keypoints, descriptors, valid)
