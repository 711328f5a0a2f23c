"""Fixed-trial RANSAC for the fundamental matrix and an affine transform
(counterpart of ``tadataka_tpu/features/ransac.py``).  Every trial runs at
once as one batch: each samples its minimal set, fits the model (batched
SVD or solve) and scores every candidate; the first trial with the most
inliers wins.  No early exit.

Randomness comes from an explicit source ``rng``: a ``torch.Generator``
(its draws advance from call to call), or a callable ``uniform(site,
shape)`` that returns uniform [0, 1) floats as an array, given the name
of the drawing site (a string or tuple) and the shape.  The JAX package
draws ``jax.random.uniform(key, (n_trials, n_samples))`` from fixed keys;
a callable can hand the port those very draws.  Batched over leading dims
of the point sets; a batch (B, N) takes a list of B sites, one for each
problem's draws.

The same bits on the CPU and the card: the 8-point fit's SVDs run on the
host (``core/solvers.py``), products of 3-vectors sum left to right,
means and norms in a fixed order, roots correctly rounded
(``core/rounding.py``).
"""

import numpy as np
import torch

from tadataka_torch.core.rounding import (
    as_divisor, dot, matmul_small, mean, norm, sqrt)
from tadataka_torch.core.solvers import nullspace_vector, on_host, solve
from tadataka_torch.core.transforms import to_homogeneous
from tadataka_torch.device import upload
from tadataka_torch.features.filters import SQRT2, hartley_matrix
from tadataka_torch.utils.timing import probe

DEFAULT_TRIALS = 128


def default_generator(device, seed=3939):
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    return torch.Generator(device=device).manual_seed(seed)


def uniform_draws(rng, site, shape, device):
    """float32 uniform [0, 1) draws of ``shape`` on ``device`` from
    ``rng`` (a ``torch.Generator`` on that device, or a callable
    ``uniform(site, shape)``).  A list of sites draws shape[1:] for each
    and stacks them."""
    if isinstance(site, list):
        assert len(site) == shape[0], (site, shape)
        return torch.stack([uniform_draws(rng, s, shape[1:], device)
                            for s in site])
    if isinstance(rng, torch.Generator):
        return torch.rand(shape, generator=rng, device=device)
    return upload(np.array(rng(site, tuple(shape)), np.float32), device)


def _sample_valid_indices(r, mask):
    """Indices (..., n_trials, n_samples) into the valid (``mask`` (...,
    N)) positions from uniform draws ``r`` (..., n_trials, n_samples): the
    valid positions are moved to the front by a stable sort of the mask,
    and floor(r * n_valid) indexes that prefix."""
    order = torch.argsort(torch.logical_not(mask).to(torch.uint8), dim=-1,
                          stable=True)
    n_valid = torch.clamp(torch.sum(mask, dim=-1), min=1)
    idx = torch.floor(r * n_valid[..., None, None]).long()
    # an index past the end is clamped, as a JAX gather clamps it
    idx = torch.clamp(idx, max=mask.shape[-1] - 1)
    flat = idx.reshape(idx.shape[:-2] + (-1,))
    return torch.gather(order, -1, flat).reshape(idx.shape)


def take_rows(x, idx):
    """x (..., N, d) at the indices idx (..., T, S) -> (..., T, S, d)."""
    flat = idx.reshape(idx.shape[:-2] + (-1, 1))
    rows = torch.gather(x, -2, flat.expand(flat.shape[:-1] + x.shape[-1:]))
    return rows.reshape(idx.shape + x.shape[-1:])


def _normalize_points(points):
    """Hartley normalization: zero mean, mean distance sqrt(2)."""
    center = mean(points, -2)
    centered = points - center[..., None, :]
    scale = as_divisor(SQRT2, points) / (mean(norm(centered), -1) + 1e-12)
    return centered * scale[..., None, None], hartley_matrix(scale, center)


def rank2(F):
    """F with its smallest singular value set to 0."""
    U, s, Vt = torch.linalg.svd(F)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
    return (U * s[..., None, :]) @ Vt


def rank2_nullspace(A):
    """rank2 of the null vector of A (..., m, 9) as a 3x3 matrix: both
    SVDs in one host call."""
    return on_host(lambda a: rank2(nullspace_vector(a).reshape(
        a.shape[:-2] + (3, 3))), A)


def _eight_point(kp1, kp2):
    """Normalized 8-point fundamental matrices from (..., 8, 2) pairs."""
    x1, T1 = _normalize_points(kp1)
    x2, T2 = _normalize_points(kp2)
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2,
                     u1, v1, torch.ones_like(u1)], dim=-1)
    F = matmul_small(matmul_small(T2.transpose(-1, -2), rank2_nullspace(A)),
                     T1)
    f22 = F[..., 2:3, 2:3]
    return F / (f22 + torch.where(torch.abs(f22) < 1e-12, 1e-12, 0.0))


def sampson_distance(F, kp1, kp2):
    """Per-match Sampson distance (..., N) for fundamental matrices F
    (..., 3, 3) and matches (..., N, 2)."""
    x1 = to_homogeneous(kp1)
    x2 = to_homogeneous(kp2)
    Fx1 = matmul_small(x1, F.transpose(-1, -2))
    Ftx2 = matmul_small(x2, F)
    num = dot(x2, Fx1) ** 2
    den = (Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2
           + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2)
    return num / (den + 1e-12)


def _best_trial(models, inliers, site=None):
    """The model of the first trial with the most inliers: models (..., T,
    a, b), inliers (..., T, N)."""
    counts = torch.sum(inliers, dim=-1)
    best = torch.argmax(counts, dim=-1)
    probe(f"RANSAC {site}", models=models, trial_inliers=counts, best=best)
    index = best[..., None, None, None].expand(
        best.shape + (1,) + models.shape[-2:])
    return torch.gather(models, -3, index)[..., 0, :, :]


def ransac_fundamental(kp1, kp2, mask, rng, residual_threshold=1.0,
                       n_trials=DEFAULT_TRIALS, site="fundamental"):
    """Returns (F_best, inlier_mask).  The residual is sqrt(Sampson), as
    skimage's FundamentalMatrixTransform's."""
    r = uniform_draws(rng, site, mask.shape[:-1] + (n_trials, 8),
                      kp1.device)
    samples = _sample_valid_indices(r, mask)
    Fs = _eight_point(take_rows(kp1, samples), take_rows(kp2, samples))
    d = sqrt(sampson_distance(Fs, kp1[..., None, :, :],
                              kp2[..., None, :, :]))
    F_best = _best_trial(Fs, mask[..., None, :] & (d < residual_threshold),
                         site)
    d = sqrt(sampson_distance(F_best, kp1, kp2))
    return F_best, mask & (d < residual_threshold)


def _fit_affine(kp1, kp2):
    """Exact affine transforms (..., 3, 3) from 3 correspondences each."""
    A = to_homogeneous(kp1)
    px = solve(A, kp2[..., 0])
    py = solve(A, kp2[..., 1])
    last = torch.zeros_like(px)
    last[..., 2] = 1.0
    return torch.stack([px, py, last], dim=-2)


def ransac_affine(kp1, kp2, mask, rng, residual_threshold=1.0,
                  n_trials=DEFAULT_TRIALS, site="affine"):
    """Returns (affine_matrix, inlier_mask)."""
    r = uniform_draws(rng, site, mask.shape[:-1] + (n_trials, 3),
                      kp1.device)
    samples = _sample_valid_indices(r, mask)
    Ms = _fit_affine(take_rows(kp1, samples), take_rows(kp2, samples))

    def distances(M, p1, p2):
        pred = matmul_small(to_homogeneous(p1), M.transpose(-1, -2))
        return norm(pred[..., :2] - p2)

    d = distances(Ms, kp1[..., None, :, :], kp2[..., None, :, :])
    M_best = _best_trial(Ms, mask[..., None, :] & (d < residual_threshold))
    return M_best, mask & (distances(M_best, kp1, kp2) < residual_threshold)
