"""Visualization: 3D maps, trajectories, camera frusta, matches, depth
maps (counterpart of ``tadataka_tpu/viz/plot.py``).

Parity surface: the reference tadataka's ``plot/`` (map, trajectory,
cameras, matches, visualizers, debug) and the flag-colored depth
dashboards of its ``examples/plot.py``.  Functional equivalents over
matplotlib, which is imported inside the functions; all entry points
accept numpy arrays or tensors (on any device) and take an
``ax``/``show`` so they compose into dashboards or headless tests.
"""

import numpy as np
import torch

from tadataka_torch.flags import Flag


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _axis3d(fig=None):
    import matplotlib.pyplot as plt
    fig = fig or plt.figure()
    return fig, fig.add_subplot(111, projection="3d")


def _equal_aspect_3d(ax):
    limits = np.array([ax.get_xlim3d(), ax.get_ylim3d(), ax.get_zlim3d()])
    origin = limits.mean(axis=1)
    radius = 0.5 * np.max(limits[:, 1] - limits[:, 0])
    ax.set_xlim3d(origin[0] - radius, origin[0] + radius)
    ax.set_ylim3d(origin[1] - radius, origin[1] + radius)
    ax.set_zlim3d(origin[2] - radius, origin[2] + radius)


_FRUSTUM = np.array([
    [-0.5, -0.5, 1.0], [0.5, -0.5, 1.0], [0.5, 0.5, 1.0], [-0.5, 0.5, 1.0],
    [0.0, 0.0, 0.0]])


def plot_cameras(ax, poses, scale=1.0):
    """Draw camera frusta for camera->world poses."""
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection
    for pose in poses:
        R = _np(pose.R)
        t = _np(pose.t)
        v = _FRUSTUM * scale @ R.T + t
        faces = np.array([[v[0], v[1], v[4]], [v[0], v[3], v[4]],
                          [v[2], v[1], v[4]], [v[2], v[3], v[4]]])
        ax.add_collection3d(Poly3DCollection(
            faces, facecolors="cyan", linewidths=1, edgecolors="red",
            alpha=0.25))
        axis_pts = np.array([[0, 0, 0], [0, 0, scale]]) @ R.T + t
        ax.plot(axis_pts[:, 0], axis_pts[:, 1], axis_pts[:, 2], c="red")
    return ax


def plot_map(poses, points, colors=None, show=True, camera_scale=None):
    """3D map + camera frusta (plot/map.py equivalent)."""
    import matplotlib.pyplot as plt
    points = _np(points)
    fig, ax = _axis3d()
    if len(points):
        if colors is None:
            c = np.mean(np.abs(points), axis=1)
            colors = c / max(c.max(), 1e-12)
        ax.scatter(points[:, 0], points[:, 1], points[:, 2],
                   s=1, c=colors)
    if camera_scale is None:
        extent = np.ptp(points, axis=0).max() if len(points) else 1.0
        camera_scale = 0.05 * extent
    plot_cameras(ax, poses, scale=camera_scale)
    _equal_aspect_3d(ax)
    if show:
        plt.show()
    return fig


def plot_trajectory(positions, gt_positions=None, show=True):
    """3D trajectory polyline(s) (plot/trajectory.py equivalent)."""
    import matplotlib.pyplot as plt
    positions = _np(positions)
    fig, ax = _axis3d()
    ax.plot(positions[:, 0], positions[:, 1], positions[:, 2],
            label="estimated")
    if gt_positions is not None:
        gt = _np(gt_positions)
        ax.plot(gt[:, 0], gt[:, 1], gt[:, 2], label="ground truth")
    ax.legend()
    _equal_aspect_3d(ax)
    if show:
        plt.show()
    return fig


def plot_matches(image0, image1, keypoints0, keypoints1, matches,
                 mask=None, show=True):
    """Side-by-side match visualization (plot/matches.py equivalent)."""
    import matplotlib.pyplot as plt
    image0, image1 = _np(image0), _np(image1)
    keypoints0, keypoints1 = _np(keypoints0), _np(keypoints1)
    matches = _np(matches)
    if mask is not None:
        matches = matches[_np(mask)]

    H = max(image0.shape[0], image1.shape[0])
    W0 = image0.shape[1]
    canvas = np.zeros((H, W0 + image1.shape[1]))
    canvas[:image0.shape[0], :W0] = image0
    canvas[:image1.shape[0], W0:] = image1

    fig, ax = plt.subplots()
    ax.imshow(canvas, cmap="gray")
    for i0, i1 in matches:
        p0 = keypoints0[i0]
        p1 = keypoints1[i1]
        ax.plot([p0[0], p1[0] + W0], [p0[1], p1[1]], linewidth=0.5)
    ax.axis("off")
    if show:
        plt.show()
    return fig


def plot_depth_dashboard(image, depth_map, variance_map=None, flag_map=None,
                         gt_depth=None, show=True):
    """Flag-colored depth dashboard (examples/plot.py equivalent)."""
    import matplotlib.pyplot as plt
    panels = [("image", _np(image), "gray"),
              ("depth", _np(depth_map), "viridis")]
    if gt_depth is not None:
        panels.append(("gt depth", _np(gt_depth), "viridis"))
    if variance_map is not None:
        panels.append(("variance", _np(variance_map), "magma"))
    if flag_map is not None:
        panels.append(("flags", _np(flag_map), "tab10"))

    fig, axes = plt.subplots(1, len(panels), figsize=(4 * len(panels), 4))
    if len(panels) == 1:
        axes = [axes]
    for ax, (title, data, cmap) in zip(axes, panels):
        im = ax.imshow(data, cmap=cmap)
        ax.set_title(title)
        ax.axis("off")
        fig.colorbar(im, ax=ax, fraction=0.046)
    if show:
        plt.show()
    return fig


def flag_legend():
    """Name -> value mapping for flag maps (debug helper)."""
    return {f.name: int(f) for f in Flag}
