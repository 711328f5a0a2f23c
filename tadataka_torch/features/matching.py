"""Descriptor matching (counterpart of ``tadataka_tpu/features/
matching.py``): mutual nearest neighbours and the ratio test over a dense
Hamming matrix, and the Matcher pipeline match -> RANSAC fundamental ->
chi-squared homography filter.

For +-1 descriptors the Hamming matrix is (D - A B^T) / 2, one matrix
product; +-1 products summed in float32 over D <= 512 are exact integers
on every device.  Masked argmins (the first index among ties, as in JAX)
replace boolean compaction; match lists keep the capacity K1.  Batched
over leading dims.
"""

from typing import NamedTuple

import torch

from tadataka_torch.features.filters import symmetric_transfer_filter
from tadataka_torch.features.ransac import (
    default_generator, ransac_fundamental)

_BIG = 1e9
_EPS = torch.finfo(torch.float32).eps


class Matches(NamedTuple):
    indices: torch.Tensor  # (K1, 2) int64: (index in set 1, index in set 2)
    mask: torch.Tensor     # (K1,) bool

    @property
    def n_valid(self):
        return torch.sum(self.mask)


def hamming_distances(descriptors1, descriptors2):
    """(..., K1, K2) Hamming distances between +-1 codes."""
    D = descriptors1.shape[-1]
    S = descriptors1 @ descriptors2.transpose(-1, -2)
    return (D - S) * 0.5


def _masked_distances(descriptors1, descriptors2, mask1, mask2):
    dist = hamming_distances(descriptors1, descriptors2)
    dist = torch.where(mask1[..., :, None], dist, _BIG)
    return torch.where(mask2[..., None, :], dist, _BIG)


def _nearest(dist, mask1, cross_check):
    """(best2, best_d, second_d, valid) of a masked distance matrix:
    each row's nearest column, its distance, the second distance and the
    mutual-nearest test."""
    best2 = torch.argmin(dist, dim=-1)
    best_d = torch.gather(dist, -1, best2[..., None])[..., 0]
    valid = mask1 & (best_d < _BIG)
    if cross_check:
        best1 = torch.argmin(dist, dim=-2)
        rows = torch.arange(dist.shape[-2], device=dist.device)
        valid = valid & (torch.gather(best1, -1, best2) == rows)
    second_d = torch.min(dist.scatter(-1, best2[..., None], _BIG), dim=-1)[0]
    return best2, best_d, second_d, valid


def _matches(best2, valid):
    rows = torch.arange(best2.shape[-1], device=best2.device)
    return Matches(torch.stack([rows.expand_as(best2), best2], dim=-1), valid)


def match_descriptors(descriptors1, descriptors2, mask1, mask2,
                      cross_check=True, max_ratio=0.8):
    """Masked mutual-NN + ratio-test matching; Matches of capacity K1."""
    dist = _masked_distances(descriptors1, descriptors2, mask1, mask2)
    best2, best_d, second_d, valid = _nearest(dist, mask1, cross_check)
    if max_ratio < 1.0:
        second_d = torch.where(second_d == 0.0, _EPS, second_d)
        valid = valid & (best_d / second_d < max_ratio)
    return _matches(best2, valid)


def match_descriptors_guided(descriptors1, descriptors2, mask1, mask2,
                             predicted2, keypoints2, radius,
                             cross_check=True, max_ratio=0.9):
    """Spatially gated matching: j in set 2 is admissible for i only if
    ``keypoints2[j]`` lies within ``radius`` of ``predicted2[i]`` (the
    projection of i's 3D point into image 2), as in local-map tracking."""
    dist = _masked_distances(descriptors1, descriptors2, mask1, mask2)
    diff = predicted2[..., :, None, :] - keypoints2[..., None, :, :]
    sq = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
    r = torch.full((), radius, dtype=sq.dtype, device=sq.device)
    dist = torch.where(sq <= r * r, dist, _BIG)
    best2, best_d, second_d, valid = _nearest(dist, mask1, cross_check)
    if max_ratio < 1.0:
        # a second best outside the gate means "unambiguous"
        ratio_ok = (second_d >= _BIG) | (
            best_d / torch.clamp(second_d, min=_EPS) < max_ratio)
        valid = valid & ratio_ok
    return _matches(best2, valid)


def _filter(indices, mask, kps1, kp2, rng, sites, enable_ransac,
            enable_homography_filter, min_inliers):
    """Matcher's RANSAC and homography filters over a batch of match
    lists (..., K) with keypoints kps1 (..., K1, 2) and kp2 (K2, 2)."""
    p1 = torch.gather(kps1, -2, indices[..., 0:1].expand(
        indices.shape[:-1] + (2,)))
    p2 = kp2[indices[..., 1]]
    enough = torch.sum(mask, dim=-1, keepdim=True) >= min_inliers
    if enable_ransac:
        _, inliers = ransac_fundamental(p1, p2, mask, rng, site=sites)
        mask = torch.where(enough, mask & inliers, mask)
    if enable_homography_filter:
        keep = symmetric_transfer_filter(p1, p2, mask, p=0.95)
        mask = torch.where(enough, mask & keep, mask)
    return mask


def match_pairs_stacked(descs1, kps1, masks1, desc2, kp2, mask2, rng,
                        sites=None, enable_ransac=True,
                        enable_homography_filter=True, min_inliers=12):
    """The stacked features of V viewpoints (V, K, D) against one new
    frame: returns (indices (V, K, 2), masks (V, K)), each pair as
    ``Matcher.__call__`` would give it.  The RANSAC draws of pair i come
    from site ``sites[i]`` (by default ("match", i, V))."""
    V = descs1.shape[0]
    if sites is None:
        sites = [("match", i, V) for i in range(V)]
    matches = match_descriptors(descs1, desc2, masks1, mask2)
    masks = _filter(matches.indices, matches.mask, kps1, kp2, rng, sites,
                    enable_ransac, enable_homography_filter, min_inliers)
    return matches.indices, masks


class Matcher:
    """match -> RANSAC(F) -> chi^2 homography filter, with the capacity
    kept and pairs under ``min_inliers`` matches left unfiltered.

    ``rng`` is the RANSAC draws' source (see ``features/ransac.py``); by
    default a generator seeded with ``seed`` on the features' device."""

    def __init__(self, enable_ransac=True, enable_homography_filter=True,
                 seed=3939, rng=None):
        self.enable_ransac = enable_ransac
        self.enable_homography_filter = enable_homography_filter
        self.seed = seed
        self.rng = rng

    def _rng(self, device):
        if self.rng is None:
            self.rng = default_generator(device, self.seed)
        return self.rng

    def match_many(self, features_list, features2, min_inliers=12):
        """Match every Features of ``features_list`` against
        ``features2``; returns device (indices (V, K, 2), masks (V, K))."""
        return match_pairs_stacked(
            torch.stack([f.descriptors for f in features_list]),
            torch.stack([f.keypoints for f in features_list]),
            torch.stack([f.mask for f in features_list]),
            features2.descriptors, features2.keypoints, features2.mask,
            self._rng(features2.mask.device),
            enable_ransac=self.enable_ransac,
            enable_homography_filter=self.enable_homography_filter,
            min_inliers=min_inliers)

    def __call__(self, features1, features2, min_inliers=12):
        matches = match_descriptors(
            features1.descriptors, features2.descriptors,
            features1.mask, features2.mask)
        mask = _filter(matches.indices[None], matches.mask[None],
                       features1.keypoints[None], features2.keypoints,
                       self._rng(features2.mask.device), ["match"],
                       self.enable_ransac, self.enable_homography_filter,
                       min_inliers)[0]
        return Matches(matches.indices, mask)
