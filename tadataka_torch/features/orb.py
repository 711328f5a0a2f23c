"""ORB-style oriented binary descriptors, steered BRIEF (counterpart of
``tadataka_tpu/features/orb.py``): the intensity-centroid orientation
(Rosin moments, as in Rublee et al., ICCV 2011) and a Gaussian BRIEF
pattern rotated by each keypoint's angle.  Descriptors are +-1 float32,
matched like BRIEF's (``features/matching.py``).

The same bits on the CPU and the card, which a descriptor needs: one
last-bit difference in a rotated sample position can move it to another
pixel and flip a bit.
- The moments m10 and m01 sum the disk's 149 taps pairwise in a fixed
  order (``rounding.fixed_order_sum``); the angle is ``rounding.atan2``
  and its cosine and sine ``rounding.cos`` and ``rounding.sin``.
- The JAX einsum "kij,dj->kdi" of the pattern's rotation is written out
  per coordinate as two rounded products and one sum.
- ``torch.round`` rounds half to even, as ``jnp.round`` does.
- The sampling pattern is computed on the host with numpy exactly as the
  JAX package computes it (``default_rng(7)``).
Against the JAX package the moments' sums run in another order, so the
angles agree to a few ulps and a sample lying on a rounding boundary can
differ.
"""

from functools import lru_cache

import numpy as np
import torch

from tadataka_torch.core.rounding import atan2, cos, fixed_order_sum, sin
from tadataka_torch.device import constant
from tadataka_torch.features.brief import _smooth
from tadataka_torch.features.detector import Features, detect_fast

DESCRIPTOR_SIZE = 256
PATCH_SIZE = 32


@lru_cache(maxsize=None)
def _gaussian_pattern(descriptor_size=DESCRIPTOR_SIZE,
                      patch_size=PATCH_SIZE, seed=7):
    """Fixed Gaussian sampling pattern (BRIEF-paper G II: sigma = S/5),
    clipped so rotated samples stay inside the patch radius."""
    rng = np.random.default_rng(seed)
    sigma = patch_size / 5.0
    # keep within radius patch/2 - 2 so any rotation stays in the patch
    r_max = patch_size / 2.0 - 2.0
    pos = rng.normal(0.0, sigma, (2, descriptor_size, 2))
    norm = np.linalg.norm(pos, axis=-1, keepdims=True)
    pos = np.where(norm > r_max, pos * (r_max / norm), pos)
    return (pos[0].astype(np.float32), pos[1].astype(np.float32))


@lru_cache(maxsize=None)
def _disk_offsets(radius=7):
    """Integer offsets of a filled disk, as a fixed (M, 2) [dx, dy] table."""
    ys, xs = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    inside = xs ** 2 + ys ** 2 <= radius ** 2
    return np.stack([xs[inside], ys[inside]], axis=-1).astype(np.int32)


def corner_orientations(image, keypoints, radius=7):
    """Intensity-centroid angle per keypoint: atan2(m01, m10) over a disk.
    keypoints: (K, 2) [x, y].  Returns (K,) angles in radians."""
    H, W = image.shape
    offs = constant(_disk_offsets(radius), image.device)
    kx = torch.round(keypoints[:, 0]).to(torch.int64)
    ky = torch.round(keypoints[:, 1]).to(torch.int64)
    xs = torch.clamp(kx[:, None] + offs[None, :, 0], 0, W - 1)
    ys = torch.clamp(ky[:, None] + offs[None, :, 1], 0, H - 1)
    patch = image[ys, xs]                              # (K, M)
    m10 = fixed_order_sum(patch * offs[None, :, 0])
    m01 = fixed_order_sum(patch * offs[None, :, 1])
    return atan2(m01, m10)


def orb_descriptors(image, keypoints, mask, patch_size=PATCH_SIZE,
                    descriptor_size=DESCRIPTOR_SIZE):
    """Steered-BRIEF +-1 descriptors.  Returns (bits (K, D), valid (K,),
    orientations (K,))."""
    H, W = image.shape
    smoothed = _smooth(image)
    half = patch_size // 2
    p0, p1 = (constant(p, image.device)
              for p in _gaussian_pattern(descriptor_size, patch_size))

    theta = corner_orientations(image, keypoints)
    c, s = cos(theta)[:, None], sin(theta)[:, None]

    kx = keypoints[:, 0]
    ky = keypoints[:, 1]
    inside = (kx >= half) & (kx < W - half) & (ky >= half) & (ky < H - half)
    valid = mask & inside

    def sample(pos):
        # the pattern rotated per keypoint: [c -s; s c] @ pos
        rx = c * pos[None, :, 0] + (-s) * pos[None, :, 1]
        ry = s * pos[None, :, 0] + c * pos[None, :, 1]
        xs = torch.clamp(torch.round(kx[:, None] + rx).to(torch.int64),
                         0, W - 1)
        ys = torch.clamp(torch.round(ky[:, None] + ry).to(torch.int64),
                         0, H - 1)
        return smoothed[ys, xs]                        # (K, D)

    bits = torch.where(sample(p0) < sample(p1), 1.0, -1.0).to(torch.float32)
    return bits, valid, theta


def extract_orb_features(image, max_keypoints=512, threshold=50.0 / 255.0,
                         patch_size=PATCH_SIZE):
    """FAST + oriented BRIEF, a drop-in for ``extract_features``."""
    feats = detect_fast(image, threshold, max_keypoints)
    bits, valid, _ = orb_descriptors(image, feats.keypoints, feats.mask,
                                     patch_size)
    return Features(feats.keypoints, bits, valid)
