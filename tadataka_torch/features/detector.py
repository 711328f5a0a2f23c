"""Corner detection: the FAST segment test and Harris, with a fixed
capacity K and a validity mask (counterpart of
``tadataka_tpu/features/detector.py``).

The 16-pixel Bresenham circle is 16 rolled images, the 9-contiguous arc
test an integer running sum, and selection a 3x3 non-max suppression and
the strongest K of a stable descending sort.  Every sum runs in one fixed
order of elementwise adds, so the CPU and the card give the same bits,
and the order is the one XLA's CPU backend takes for the JAX package's
sums, so the port gives its bits too: left to right over the ring, and
``tap_sum``'s order over the taps of a blur.
"""

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from tadataka_torch.core.gradients import sobel_x, sobel_y

# Bresenham circle of radius 3, clockwise from (0, -3), as (dx, dy)
_CIRCLE = [
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
]


class Features(NamedTuple):
    keypoints: torch.Tensor    # (K, 2) [x, y] pixel coords
    descriptors: torch.Tensor  # (K, D) float +-1, or (K, 0)
    mask: torch.Tensor         # (K,) bool

    @property
    def n_valid(self):
        return torch.sum(self.mask)


def _shift2d(image, dx, dy):
    """image shifted so that out[y, x] = image[y + dy, x + dx], wrapping
    around (the 3-pixel border is masked afterwards)."""
    return torch.roll(image, shifts=(-dy, -dx), dims=(0, 1))


def tap_sum(terms):
    """Sum of a list of equally shaped tensors: the leading power of two
    of them summed pairwise, then the rest by the same rule, and the
    partial sums added left to right (5 taps: ((t0 + t1) + (t2 + t3)) +
    t4; 7 taps: ((... + ...) + (t4 + t5)) + t6).  The order of XLA's CPU
    convolution over its taps."""
    total = None
    while terms:
        n = 1 << (len(terms).bit_length() - 1)
        chunk, terms = terms[:n], terms[n:]
        while len(chunk) > 1:
            chunk = [chunk[i] + chunk[i + 1] for i in range(0, len(chunk), 2)]
        total = chunk[0] if total is None else total + chunk[0]
    return total


def separable_blur(image, taps):
    """``jnp.convolve(mode="same")`` with the host float32 ``taps`` along
    rows, then along columns, zero padded, each sum by ``tap_sum``."""
    r = len(taps) // 2
    H, W = image.shape
    flipped = [float(g) for g in taps[::-1]]
    padded = F.pad(image, (r, r))
    rows = tap_sum([padded[:, k:k + W] * flipped[k]
                    for k in range(len(taps))])
    padded = F.pad(rows, (0, 0, r, r))
    return tap_sum([padded[k:k + H] * flipped[k] for k in range(len(taps))])


def fast_score(image, threshold=50.0 / 255.0, arc_length=9):
    """FAST-9 corner response: 0 where not a corner, else the sum of the
    ring's absolute differences beyond the threshold."""
    ring = [_shift2d(image, dx, dy) for dx, dy in _CIRCLE]
    ring_t = torch.stack(ring)
    center = image[None]
    brighter = ring_t > center + threshold
    darker = ring_t < center - threshold

    def arc_exists(flags):
        # a window of arc_length consecutive ring pixels, cyclic: double
        # the ring and difference an integer running sum
        doubled = torch.cat([flags, flags[:arc_length]]).to(torch.int32)
        csum = F.pad(torch.cumsum(doubled, dim=0), (0, 0, 0, 0, 1, 0))
        window = csum[arc_length:] - csum[:-arc_length]
        return torch.any(window == arc_length, dim=0)

    is_corner = arc_exists(brighter) | arc_exists(darker)
    score = None
    for r in ring:
        diff = torch.abs(r - image) - threshold
        term = torch.where(diff > 0, diff, 0.0)
        score = term if score is None else score + term
    H, W = image.shape
    ys = torch.arange(H, device=image.device)[:, None]
    xs = torch.arange(W, device=image.device)[None, :]
    interior = (ys >= 3) & (ys < H - 3) & (xs >= 3) & (xs < W - 3)
    return torch.where(is_corner & interior, score, 0.0)


def _gaussian_kernel(sigma, radius=None):
    """Normalized float32 Gaussian taps on the host (the same float32
    operations as the JAX package's)."""
    if radius is None:
        radius = int(3 * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    g = np.exp(np.float32(-0.5) * (x / np.float32(sigma)) ** 2)
    total = g[0]
    for v in g[1:]:
        total = total + v
    return g / total


def harris_score(image, k=0.05, sigma=1.0):
    """Harris corner response from Gaussian-weighted gradient moments."""
    Ix = sobel_x(image, mode="reflect")
    Iy = sobel_y(image, mode="reflect")
    g = _gaussian_kernel(sigma)
    Sxx = separable_blur(Ix * Ix, g)
    Syy = separable_blur(Iy * Iy, g)
    Sxy = separable_blur(Ix * Iy, g)
    det = Sxx * Syy - Sxy * Sxy
    tr = Sxx + Syy
    return det - k * tr * tr


def _nms3(score):
    """3x3 non-max suppression: keep the maxima of each neighbourhood."""
    neighborhood = F.max_pool2d(score[None, None], 3, stride=1,
                                padding=1)[0, 0]
    return torch.where(score >= neighborhood, score, 0.0)


def _topk_keypoints(score, k, subpixel_score=None):
    """The strongest k grid positions, the lower flat index first among
    equal scores (``lax.top_k``'s order, by a stable descending sort),
    refined to subpixel by a parabola through ``subpixel_score`` where
    given.  Returns (keypoints (k, 2), mask (k,))."""
    H, W = score.shape
    vals, idx = torch.sort(score.reshape(-1), descending=True, stable=True)
    vals, idx = vals[:k], idx[:k]
    ys = idx // W
    xs = idx % W
    fx = xs.float()
    fy = ys.float()
    if subpixel_score is not None:
        s = subpixel_score

        def parabola_offset(sm, s0, sp):
            denom = sm - 2.0 * s0 + sp
            off = 0.5 * (sm - sp) / torch.where(torch.abs(denom) < 1e-12,
                                                1e-12, denom)
            return torch.clamp(off, -0.5, 0.5)

        xs0 = torch.clamp(xs, 1, W - 2)
        ys0 = torch.clamp(ys, 1, H - 2)
        dx = parabola_offset(s[ys0, xs0 - 1], s[ys0, xs0], s[ys0, xs0 + 1])
        dy = parabola_offset(s[ys0 - 1, xs0], s[ys0, xs0], s[ys0 + 1, xs0])
        fx = xs0.float() + dx
        fy = ys0.float() + dy
    return torch.stack([fx, fy], dim=-1), vals > 0.0


def detect_fast(image, threshold=50.0 / 255.0, max_keypoints=512):
    """FAST-9 corners, the strongest ``max_keypoints`` after NMS, subpixel."""
    raw = fast_score(image, threshold)
    keypoints, mask = _topk_keypoints(_nms3(raw), max_keypoints,
                                      subpixel_score=raw)
    return Features(keypoints, image.new_zeros((max_keypoints, 0)), mask)


def detect_harris(image, max_keypoints=512, rel_threshold=1e-4):
    raw = harris_score(image)
    score = _nms3(raw)
    score = torch.where(score > rel_threshold * torch.max(score), score, 0.0)
    keypoints, mask = _topk_keypoints(score, max_keypoints,
                                      subpixel_score=raw)
    return Features(keypoints, image.new_zeros((max_keypoints, 0)), mask)
