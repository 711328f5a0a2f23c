"""Live VO viewers: matplotlib FuncAnimation dashboards (counterpart of
``tadataka_tpu/viz/animation.py``).

Parity surface: the reference tadataka's ``examples/animation.py`` (DVO
drawer: 3D trajectory + depth + image panels, plus a rotating
aligned-trajectory view) and ``examples/animation_feature_based.py``
(trajectory + point cloud + current image).  Here they are reusable
library classes rather than scripts: each takes an estimator with the
framework's VO API and a frame iterable, builds the figure, and exposes
``animate()`` -> FuncAnimation (save to file or show).

Headless-safe: construction draws nothing until ``animate``; tests step
``update(i)`` directly under the Agg backend.
"""

import numpy as np

from tadataka_torch.metrics import umeyama_alignment, apply_similarity
from tadataka_torch.viz.plot import _equal_aspect_3d, _np


def _set_line_3d(line, data):
    line.set_data(data[:, 0], data[:, 1])
    line.set_3d_properties(data[:, 2])


def _set_range(ax, data):
    lo, hi = np.min(data, axis=0), np.max(data, axis=0)
    span = np.maximum(hi - lo, 1e-6)
    ax.set_xlim([lo[0], lo[0] + span[0]])
    ax.set_ylim([lo[1], lo[1] + span[1]])
    ax.set_zlim([lo[2], lo[2] + span[2]])
    _equal_aspect_3d(ax)


class VOAnimation:
    """DVO-style live dashboard: 3D predicted trajectory, depth, image.

    estimator: object with ``estimate(frame) -> pose`` (world pose, ``.t``),
    such as ``DvoTrajectory`` or ``SemiDenseVO``.
    dataset: indexable of frames with ``.image``, ``.depth_map``, ``.pose``.
    """

    def __init__(self, estimator, dataset, figsize=(16, 10)):
        import matplotlib.pyplot as plt
        self.estimator = estimator
        self.dataset = dataset
        self.fig = plt.figure(figsize=figsize)
        self.ax_traj = self.fig.add_subplot(1, 2, 1, projection="3d")
        self.ax_depth = self.fig.add_subplot(2, 2, 2)
        self.ax_image = self.fig.add_subplot(2, 2, 4)
        self.trajectory_pred = np.empty((0, 3))
        self.trajectory_true = np.empty((0, 3))
        self.line = self.ax_traj.plot([0], [0], [0], color="blue")[0]
        first = dataset[0]
        self.depth_axis = self.ax_depth.imshow(_np(first.depth_map),
                                               cmap="gray")
        self.image_axis = self.ax_image.imshow(_np(first.image),
                                               cmap="gray")

    def update(self, i):
        frame = self.dataset[i]
        pose = self.estimator.estimate(frame)
        self.trajectory_pred = np.vstack([self.trajectory_pred,
                                          _np(pose.t)[None]])
        if frame.pose is not None:
            self.trajectory_true = np.vstack([self.trajectory_true,
                                              _np(frame.pose.t)[None]])
        _set_line_3d(self.line, self.trajectory_pred)
        _set_range(self.ax_traj, self.trajectory_pred)
        self.depth_axis.set_array(_np(frame.depth_map))
        self.image_axis.set_array(_np(frame.image))
        return (self.line, self.depth_axis, self.image_axis)

    def animate(self, interval=50):
        from matplotlib import animation
        return animation.FuncAnimation(
            self.fig, self.update, len(self.dataset), interval=interval,
            blit=False)


class FeatureVOAnimation:
    """Feature-based VO live dashboard: trajectory + map points + image.

    vo: ``FeatureBasedVO``-like with ``estimate(frame)``/``export_points()``.
    """

    def __init__(self, vo, dataset, figsize=(16, 10)):
        import matplotlib.pyplot as plt
        self.vo = vo
        self.dataset = dataset
        self.fig = plt.figure(figsize=figsize)
        self.ax_map = self.fig.add_subplot(121, projection="3d")
        self.ax_image = self.fig.add_subplot(122)
        self.ax_image.axis("off")
        self.line = self.ax_map.plot([0], [0], [0], color="red")[0]
        self.points = self.ax_map.scatter([0], [0], [0], s=0.5)
        self.ax_map.view_init(-70, -90)
        self.trajectory = np.empty((0, 3))
        self.image_axis = self.ax_image.imshow(_np(dataset[0].image),
                                               cmap="gray")

    def update(self, i):
        frame = self.dataset[i]
        pose = self.vo.estimate(frame)
        if pose is not None:
            self.trajectory = np.vstack([self.trajectory, _np(pose.t)[None]])
        points = self.vo.export_points()
        if isinstance(points, tuple):  # (points, colors)
            points = points[0]
        points = _np(points)
        if points.size:
            self.points._offsets3d = (points[:, 0], points[:, 1],
                                      points[:, 2])
            _set_range(self.ax_map,
                       np.vstack([points, self.trajectory])
                       if self.trajectory.size else points)
        if self.trajectory.size:
            _set_line_3d(self.line, self.trajectory)
        self.image_axis.set_array(_np(frame.image))
        return (self.line, self.points, self.image_axis)

    def animate(self, interval=100):
        from matplotlib import animation
        return animation.FuncAnimation(
            self.fig, self.update, len(self.dataset), interval=interval,
            blit=False)


class TrajectoryOrbitAnimation:
    """Rotating 3D view of ground truth vs (Umeyama-aligned) prediction —
    the reference's TrajectoryVisualizer (examples/animation.py:68-81)."""

    def __init__(self, trajectory_true, trajectory_pred, align=True,
                 figsize=(6, 6)):
        import matplotlib.pyplot as plt
        P = _np(trajectory_pred)
        Q = _np(trajectory_true)
        if align and len(P) == len(Q) and len(P) >= 3:
            R, t, s = umeyama_alignment(P, Q)
            P = _np(apply_similarity(R, t, s, P))
        self.fig = plt.figure(figsize=figsize)
        self.ax = self.fig.add_subplot(111, projection="3d")
        self.ax.plot(Q[:, 0], Q[:, 1], Q[:, 2], color="red",
                     label="ground truth")
        self.ax.plot(P[:, 0], P[:, 1], P[:, 2], color="blue",
                     label="prediction")
        self.ax.legend()

    def update(self, angle):
        self.ax.view_init(30, angle)
        return (self.fig,)

    def animate(self, interval=50, frames=360):
        from matplotlib import animation
        return animation.FuncAnimation(self.fig, self.update, frames=frames,
                                       interval=interval, blit=False)
