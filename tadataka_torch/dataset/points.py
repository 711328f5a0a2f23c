"""Synthetic point-cloud scenes (counterpart of
``tadataka_tpu/dataset/points.py``, numpy only): a cubic lattice, the
donut camera-orbit scene, and translations that keep every point in
front of the camera."""

import numpy as np


def cubic_lattice(N):
    array = np.arange(N)
    xs, ys, zs = np.meshgrid(array, array, array)
    return np.vstack((xs.flatten(), ys.flatten(), zs.flatten())).T.astype(
        np.float64)


def donut(inner_r, outer_r, height=5, point_density=24, n_viewpoints=60,
          offset=1e-3):
    """Points on a torus-like double ring; cameras orbit between the rings
    looking along the tangent.  Returns (camera_omegas, camera_locations,
    points)."""
    assert isinstance(height, int)
    assert outer_r > inner_r

    def round_points(thetas):
        return np.vstack([np.cos(thetas),
                          np.zeros(thetas.shape[0]),
                          np.sin(thetas)]).T

    def rings(level_y):
        thetas = np.linspace(0, 2 * np.pi, point_density + 1)[:-1]
        inner = inner_r * round_points(thetas)
        outer = outer_r * round_points(thetas)
        inner[:, 1] = level_y
        outer[:, 1] = level_y
        return np.vstack((inner, outer))

    point_ys = np.arange(height)
    points = np.vstack([rings(y) for y in point_ys])

    camera_r = (inner_r + outer_r) / 2.0
    camera_y = (point_ys[0] + point_ys[-1]) / 2.0
    thetas = np.linspace(0, 2 * np.pi, n_viewpoints + 1)[:-1] + offset

    camera_locations = camera_r * round_points(thetas)
    camera_locations[:, 1] = camera_y
    camera_omegas = np.vstack([np.zeros(n_viewpoints), -thetas,
                               np.zeros(n_viewpoints)]).T
    return camera_omegas, camera_locations, points


def generate_translations(rotations, points, depth_margin=2.0):
    """Translations placing every rotated point at depth > depth_margin."""
    n_viewpoints = rotations.shape[0]
    translations = np.empty((n_viewpoints, 3))
    offset = np.array([0, 0, depth_margin])
    for i in range(n_viewpoints):
        P = points @ rotations[i].T
        translations[i] = -P[np.argmin(P[:, 2])] + offset
    return translations
