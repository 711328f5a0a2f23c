"""Affine flow between matched keypoint sets (counterpart of
``tadataka_tpu/features/flow.py``): a per-axis robust IRLS regression of
the affine map.  The map and its inverse are applied by left-to-right
3x3 products, and the inverse is the fixed-order adjugate inverse
(``rounding.inv3``), so the CPU and the card give the same bits."""

from typing import NamedTuple

import torch

from tadataka_torch.core.rounding import inv3, matmul_small
from tadataka_torch.core.transforms import to_homogeneous
from tadataka_torch.robust.irls import irls_fit


class AffineTransform(NamedTuple):
    matrix: torch.Tensor  # (3, 3)

    def __call__(self, points):
        p = matmul_small(to_homogeneous(points), self.matrix.T)
        return p[..., :2]

    def inverse(self, points):
        p = matmul_small(to_homogeneous(points), inv3(self.matrix).T)
        return p[..., :2]


def estimate_affine_transform(keypoints0, keypoints1, mask=None):
    """Robust affine fit keypoints0 -> keypoints1 (masked rows zeroed):
    both rows of the map fitted in one batched ``irls_fit``."""
    X = to_homogeneous(keypoints0)
    y = keypoints1.T
    if mask is not None:
        w = mask.to(X.dtype)
        X = X * w[:, None]
        y = y * w
    M = torch.eye(3, dtype=X.dtype, device=X.device)
    M = torch.cat([irls_fit(X, y), M[2:]])
    return AffineTransform(M)
