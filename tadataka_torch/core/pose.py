"""Pose: an SE(3) element as a (R, t) tuple of tensors (counterpart of
``tadataka_tpu/core/pose.py``).  Composition: (a * b).R = a.R @ b.R,
(a * b).t = a.R @ b.t + a.t."""

from typing import NamedTuple

import torch

from tadataka_torch.core.so3 import exp_so3
from tadataka_torch.core.se3 import exp_se3_t
from tadataka_torch.core.transforms import motion_matrix


class Pose(NamedTuple):
    R: torch.Tensor  # (..., 3, 3)
    t: torch.Tensor  # (..., 3)

    @property
    def T(self):
        """4x4 motion matrix."""
        return motion_matrix(self.R, self.t)

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

    def inv(self):
        Rt = self.R.transpose(-1, -2)
        return Pose(Rt, -(Rt @ self.t[..., None])[..., 0])

    def __mul__(self, other):
        return Pose(self.R @ other.R,
                    (self.R @ other.t[..., None])[..., 0] + self.t)
