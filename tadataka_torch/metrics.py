"""Evaluation metrics: photometric error, Umeyama alignment, ATE and RPE
(counterpart of ``tadataka_tpu/metrics.py``).

The photometric error sums over pixels in the fixed order of
``rounding.fixed_order_sum``.  The trajectory metrics take (N, 3)
positions (tensors or arrays) and compute on the host in float32, the
alignment's 3x3 SVD included; they return host tensors.
"""

import torch

from tadataka_torch.core.coordinates import image_coordinates
from tadataka_torch.core.image_range import is_in_image_range
from tadataka_torch.core.interpolation import interpolate
from tadataka_torch.core.rounding import fixed_order_sum
from tadataka_torch.core.warp import warp2d


def photometric_error(T10, camera_model0, camera_model1, I0, D0, I1):
    """Masked mean squared intensity difference after warping every
    pixel of frame 0 into frame 1."""
    us0 = image_coordinates(D0.shape, dtype=I0.dtype, device=I0.device)
    us1, _ = warp2d(T10, camera_model0, camera_model1, us0, D0.ravel())
    mask = is_in_image_range(us1, D0.shape)
    d = torch.where(mask, I0.ravel() - interpolate(I1, us1), 0.0)
    sums = fixed_order_sum(torch.stack([d * d, mask.to(d.dtype)]))
    return sums[0] / torch.clamp(sums[1], min=1.0)


class PhotometricError:
    """Closure form: ``PhotometricError(...)(pose10)``."""

    def __init__(self, camera_model0, camera_model1, I0, D0, I1):
        self.camera_model0 = camera_model0
        self.camera_model1 = camera_model1
        self.I0, self.D0, self.I1 = I0, D0, I1

    def __call__(self, pose10):
        return photometric_error(pose10.T, self.camera_model0,
                                 self.camera_model1, self.I0, self.D0,
                                 self.I1)


def _host(P):
    return torch.as_tensor(P).detach().to("cpu", torch.float32)


def umeyama_alignment(P, Q):
    """Least-squares similarity (R, t, s) minimizing ||s R p + t - q||^2
    over the rows of P, Q (N, 3)."""
    P, Q = _host(P), _host(Q)
    mean_p, mean_q = P.mean(dim=0), Q.mean(dim=0)
    X, Y = P - mean_p, Q - mean_q
    U, _, VT = torch.linalg.svd(X.T @ Y)
    V = VT.T
    # a proper rotation: flip the last axis if det < 0
    D = torch.ones(3)
    D[2] = torch.sign(torch.linalg.det(V @ U.T))
    R = V @ torch.diag(D) @ U.T
    s = torch.sum((Y @ R) * X) / torch.sum(X * X)
    t = mean_q - s * (R @ mean_p)
    return R, t, s


def apply_similarity(R, t, s, P):
    return s * (_host(P) @ R.T) + t


def absolute_trajectory_error(estimated, ground_truth, align=True):
    """RMS position error, after the Umeyama alignment when ``align``."""
    estimated, ground_truth = _host(estimated), _host(ground_truth)
    if align:
        estimated = apply_similarity(
            *umeyama_alignment(estimated, ground_truth), estimated)
    d = estimated - ground_truth
    return torch.sqrt(torch.mean(torch.sum(d * d, dim=-1)))


def relative_pose_error(estimated, ground_truth, delta=1):
    """RMS relative translation error over pose pairs ``delta`` apart."""
    estimated, ground_truth = _host(estimated), _host(ground_truth)
    d = ((estimated[delta:] - estimated[:-delta])
         - (ground_truth[delta:] - ground_truth[:-delta]))
    return torch.sqrt(torch.mean(torch.sum(d * d, dim=-1)))
