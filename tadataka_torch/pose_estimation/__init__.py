from tadataka_torch.pose_estimation.epipolar import (
    estimate_fundamental, fundamental_to_essential, decompose_essential,
    estimate_pose_change, select_valid_pose)
from tadataka_torch.pose_estimation.pnp import solve_pnp
