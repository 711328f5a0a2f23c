"""Pinhole intrinsics (counterpart of ``tadataka_tpu/camera/parameters.py``):
normalize = (u - c) / f, unnormalize = x * f + c."""

from typing import NamedTuple

import torch


class CameraParameters(NamedTuple):
    focal_length: torch.Tensor  # (2,) [fx, fy]
    offset: torch.Tensor        # (2,) [cx, cy]

    @classmethod
    def create(cls, focal_length, offset, dtype=torch.float32, device="cpu"):
        return cls(torch.as_tensor(focal_length, dtype=dtype, device=device),
                   torch.as_tensor(offset, dtype=dtype, device=device))

    @property
    def matrix(self):
        """The 3x3 intrinsic matrix [[fx, 0, cx], [0, fy, cy], [0, 0, 1]]."""
        fx, fy = self.focal_length[0], self.focal_length[1]
        cx, cy = self.offset[0], self.offset[1]
        zero = torch.zeros_like(fx)
        one = torch.ones_like(fx)
        return torch.stack([torch.stack([fx, zero, cx]),
                            torch.stack([zero, fy, cy]),
                            torch.stack([zero, zero, one])])

    @property
    def params(self):
        return self.focal_length.tolist() + self.offset.tolist()

    @classmethod
    def from_params(cls, params):
        return cls.create(params[0:2], params[2:4])

    def normalize(self, keypoints):
        """Pixel coords (..., 2) -> normalized image plane (..., 2)."""
        return (keypoints - self.offset) / self.focal_length

    def unnormalize(self, keypoints):
        return keypoints * self.focal_length + self.offset

    def normalize_xy(self, ux, uy):
        return ((ux - self.offset[0]) / self.focal_length[0],
                (uy - self.offset[1]) / self.focal_length[1])

    def unnormalize_xy(self, xn, yn):
        return (xn * self.focal_length[0] + self.offset[0],
                yn * self.focal_length[1] + self.offset[1])
