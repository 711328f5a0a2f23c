"""Pose: an SE(3) element as a (R, t) tuple of tensors (counterpart of
``tadataka_tpu/core/pose.py``).  Composition: (a * b).R = a.R @ b.R,
(a * b).t = a.R @ b.t + a.t."""

from typing import NamedTuple

import torch

from bench_port.reference.port.core.so3 import exp_so3, log_so3
from bench_port.reference.port.core.se3 import exp_se3_t, log_se3
from bench_port.reference.port.core.transforms import motion_matrix, transform_points


class Pose(NamedTuple):
    R: torch.Tensor  # (..., 3, 3)
    t: torch.Tensor  # (..., 3)

    @property
    def T(self):
        """4x4 motion matrix."""
        return motion_matrix(self.R, self.t)

    @property
    def rotvec(self):
        return log_so3(self.R)

    @classmethod
    def identity(cls, batch=(), dtype=torch.float32, device="cpu"):
        R = torch.eye(3, dtype=dtype, device=device).expand(
            batch + (3, 3)).clone()
        return cls(R, torch.zeros(batch + (3,), dtype=dtype, device=device))

    @classmethod
    def from_rotvec(cls, rotvec, t):
        return cls(exp_so3(rotvec), t)

    @classmethod
    def from_se3(cls, xi):
        """xi = [v, omega]; the translation goes through V(omega)."""
        return cls(exp_so3(xi[..., 3:]), exp_se3_t(xi))

    @classmethod
    def from_matrix(cls, T):
        return cls(T[..., :3, :3], T[..., :3, 3])

    def se3(self):
        """xi = [v, omega] of the pose (``log_se3`` of its matrix)."""
        return log_se3(self.T)

    def inv(self):
        Rt = self.R.transpose(-1, -2)
        return Pose(Rt, -(Rt @ self.t[..., None])[..., 0])

    def __mul__(self, other):
        return Pose(self.R @ other.R,
                    (self.R @ other.t[..., None])[..., 0] + self.t)

    def apply(self, P):
        """Transform 3D points (..., 3)."""
        return transform_points(self.T, P)

    def isclose(self, other, atol=1e-5):
        """Whether R and t are within ``atol`` (and 1e-5 relative, as
        ``jnp.allclose``) of the other pose's."""
        return (torch.allclose(self.R, other.R, rtol=1e-5, atol=atol)
                and torch.allclose(self.t, other.t, rtol=1e-5, atol=atol))
