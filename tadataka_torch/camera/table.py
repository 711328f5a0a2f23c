"""Precomputed undistortion lookup table (counterpart of
``tadataka_tpu/camera/table.py``): the whole pixel grid normalized once,
then any query answered by a bilinear lookup in the two maps."""

import torch

from tadataka_torch.core.coordinates import image_coordinates
from tadataka_torch.core.image_range import is_in_image_range
from tadataka_torch.core.interpolation import interpolate


class NormalizationMapTable:
    def __init__(self, camera_model, image_shape):
        self.image_shape = tuple(image_shape)
        H, W = self.image_shape
        device = camera_model.camera_parameters.focal_length.device
        xs = camera_model.normalize(image_coordinates(image_shape,
                                                      device=device))
        self._x_map = xs[:, 0].reshape(H, W)
        self._y_map = xs[:, 1].reshape(H, W)

    def normalize(self, us):
        """us (..., 2) pixel coords, which must lie in the image."""
        return torch.stack([interpolate(self._x_map, us),
                            interpolate(self._y_map, us)], dim=-1)

    def in_range(self, us):
        return is_in_image_range(us, self.image_shape)
