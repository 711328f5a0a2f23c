"""Plots and live viewers (counterpart of ``tadataka_tpu/viz``);
matplotlib is imported inside the functions."""

from tadataka_torch.viz.plot import (
    plot_map, plot_trajectory, plot_matches, plot_depth_dashboard,
    plot_cameras)
from tadataka_torch.viz.animation import (
    VOAnimation, FeatureVOAnimation, TrajectoryOrbitAnimation)
