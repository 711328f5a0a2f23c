"""Curvature-extrema hill climb, VITAMIN-E's local correction
(counterpart of ``tadataka_tpu/features/extrema_tracker.py``): each
keypoint repeatedly steps to the best of its 3x3 neighbourhood of
curvature + lambda (1 - GemanMcClure(drift)), at most 20 steps,
stopping at a local maximum; then a parabola through the landed
extremum's neighbours gives its subpixel offset.

The JAX package runs a ``fori_loop`` under ``vmap`` with a done-latch;
here the 20 steps run batched over all K keypoints on the device, with
no host read inside the loop:
- the 3x3 patches come from the curvature padded by -inf (``F.pad``), so
  the climb never steps outside;
- the neighbour list is [x, y] and the patch [y, x]: neighbour (dx, dy)
  is patch entry (dy + 1) * 3 + (dx + 1);
- ``argmax`` takes the first maximum, as ``jnp.argmax`` does;
- the parabola keeps the JAX package's 1e-12 guard, its ``isfinite``
  and its clip to [-0.5, 0.5].
Every operation is elementwise or a gather, so the CPU and the card give
the same bits.
"""

from typing import NamedTuple

import torch
import torch.nn.functional as F

from tadataka_torch.core.image_range import is_in_image_range

class GemanMcClure(NamedTuple):
    sigma_squared: float

    def compute(self, p):
        u = p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1]
        return u / (u + self.sigma_squared)


class ExtremaTracker:
    """Correct keypoints to nearby curvature maxima."""

    def __init__(self, image_curvature, lambda_, regularizer=None,
                 max_iter=20, subpixel=True):
        if regularizer is None:
            regularizer = GemanMcClure(3.0 ** 2)
        self.image_shape = tuple(image_curvature.shape)
        self.curvature = F.pad(image_curvature[None, None], (1, 1, 1, 1),
                               value=float("-inf"))[0, 0]
        self.regularizer = regularizer
        self.lambda_ = lambda_
        self.max_iter = max_iter
        self.subpixel = subpixel

    def _patches(self, p):
        """The 3x3 padded-curvature patches around p (K, 2) [x, y] in the
        padded frame, row-major [y, x]: (K, 9)."""
        Wp = self.curvature.shape[1]
        d = torch.arange(-1, 2, device=p.device)
        offsets = (d[:, None] * Wp + d[None, :]).reshape(-1)
        return self.curvature.reshape(-1)[
            (p[:, 1] * Wp + p[:, 0])[:, None] + offsets]

    def optimize(self, initial_coordinates):
        """(K, 2) float coords [x, y] -> corrected coords (K, 2)."""
        coords = initial_coordinates
        rounded = torch.round(coords)
        frac = coords - rounded
        valid = is_in_image_range(rounded, self.image_shape)
        # out-of-image keypoints climb from the corner and are discarded
        p_init = torch.where(valid[:, None], rounded,
                             torch.zeros_like(rounded)).to(torch.int64) + 1
        d = torch.arange(-1, 2, device=coords.device)
        neighbors = torch.stack([d.repeat(3), d.repeat_interleave(3)], -1)
        ddp = neighbors.to(self.curvature.dtype)
        # patch entry of each neighbour: (dy + 1) * 3 + (dx + 1)
        flat_idx = (neighbors[:, 1] + 1) * 3 + (neighbors[:, 0] + 1)
        lam = self.lambda_
        p = p_init
        done = torch.zeros(len(p), dtype=torch.bool, device=p.device)
        for _ in range(self.max_iter):
            patch = self._patches(p)
            drift = (p - p_init).to(patch.dtype)
            R = 1.0 - self.regularizer.compute(drift[:, None, :] + ddp)
            energy = patch[:, flat_idx] + lam * R
            step = neighbors[torch.argmax(energy, dim=1)]
            is_center = torch.all(step == 0, dim=1)
            p = torch.where((done | is_center)[:, None], p, p + step)
            done = done | is_center
        corrected = torch.where(valid[:, None], (p - 1).to(coords.dtype),
                                rounded)
        if not self.subpixel:
            return corrected + frac

        patch = self._patches(p)

        def parabola(cm, c0, cp):
            denom = cm - 2.0 * c0 + cp
            off = 0.5 * (cm - cp) / torch.where(
                torch.abs(denom) < 1e-12, 1e-12, denom)
            off = torch.where(torch.isfinite(off), off, 0.0)
            return torch.clamp(off, -0.5, 0.5)

        offsets = torch.stack([parabola(patch[:, 3], patch[:, 4], patch[:, 5]),
                               parabola(patch[:, 1], patch[:, 4], patch[:, 7])],
                              dim=-1).to(coords.dtype)
        offsets = torch.where(valid[:, None], offsets, frac)
        return corrected + offsets
