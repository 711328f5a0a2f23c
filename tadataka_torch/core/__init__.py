"""Tensor geometry core of the port's VO paths."""

from tadataka_torch.core.so3 import hat_so3, exp_so3, log_so3
from tadataka_torch.core.se3 import exp_se3, log_se3, exp_se3_t
from tadataka_torch.core.pose import Pose
from tadataka_torch.core.projection import pi, inv_pi
from tadataka_torch.core.transforms import (
    motion_matrix, get_rotation, get_translation, inv_motion_matrix,
    relative_transform, transform_points, to_homogeneous, from_homogeneous)
from tadataka_torch.core.warp import (
    warp_depth, warp2d, Warp2D, LocalWarp2D, Warp3D)
from tadataka_torch.core.interpolation import interpolate, interpolate_checked
from tadataka_torch.core.triangulation import (
    calc_depth0, linear_triangulation, two_view_triangulation,
    depths_from_triangulation)
from tadataka_torch.core.image_range import (
    is_in_image_range, all_in_image_range)
from tadataka_torch.core.coordinates import image_coordinates
