"""Tensor geometry core of the port's VO paths."""

from tadataka_torch.core.so3 import hat_so3, exp_so3, log_so3
from tadataka_torch.core.se3 import exp_se3_t
from tadataka_torch.core.pose import Pose
from tadataka_torch.core.projection import pi, inv_pi
from tadataka_torch.core.transforms import (
    motion_matrix, get_rotation, get_translation, inv_motion_matrix,
    relative_transform, transform_points, to_homogeneous, from_homogeneous)
from tadataka_torch.core.warp import warp_depth, warp2d
from tadataka_torch.core.interpolation import interpolate
from tadataka_torch.core.coordinates import image_coordinates
