"""TUM-format helpers: image-path lists, timestamp matching and
synchronization, pose files (counterpart of
``tadataka_tpu/dataset/tum.py``, numpy and scipy only)."""

import csv
from pathlib import Path

import numpy as np
from scipy.spatial.transform import Rotation


def load_image_paths(filepath, prefix, delimiter=" "):
    """Parse a '<timestamp> <relative path>' listing file."""
    timestamps = []
    image_paths = []
    with open(str(filepath), "r") as f:
        for row in csv.reader(f, delimiter=delimiter):
            if not row or row[0].startswith("#"):
                continue
            timestamps.append(float(row[0]))
            image_paths.append(str(Path(prefix, row[1].strip())))
    return np.array(timestamps), image_paths


def _nearest_indices(query, targets):
    """Index of the nearest target for each query (targets need not be
    sorted); a tie goes to the smaller target."""
    order = np.argsort(targets)
    sorted_t = targets[order]
    pos = np.clip(np.searchsorted(sorted_t, query), 1, len(sorted_t) - 1)
    left = sorted_t[pos - 1]
    right = sorted_t[pos]
    choose_left = (query - left) <= (right - query)
    return order[np.where(choose_left, pos - 1, pos)]


def match_timestamps(timestamps0, timestamps1, max_difference=np.inf,
                     cross_check=True):
    """Mutual-nearest-neighbour timestamp matches, (n, 2) index pairs."""
    nn01 = _nearest_indices(timestamps0, timestamps1)
    i0 = np.arange(len(timestamps0))
    if cross_check:
        mutual = _nearest_indices(timestamps1, timestamps0)[nn01] == i0
        matches = np.column_stack((i0[mutual], nn01[mutual]))
    else:
        matches = np.column_stack((i0, nn01))
    diff = np.abs(timestamps0[matches[:, 0]] - timestamps1[matches[:, 1]])
    return matches[diff <= max_difference]


def synchronize(timestamps1, timestamps2, timestamps_ref, max_diff=np.inf):
    """3-way sync: rows (index1, index2, index_ref) sharing a ref frame."""
    matches01 = match_timestamps(timestamps_ref, timestamps1, max_diff)
    matches02 = match_timestamps(timestamps_ref, timestamps2, max_diff)
    _, indices1, indices2 = np.intersect1d(
        matches01[:, 0], matches02[:, 0], return_indices=True)
    return np.column_stack((matches01[indices1, 1],
                            matches02[indices2, 1],
                            matches01[indices1, 0]))


def convert_to_tum_poses(rotations, positions):
    if len(rotations) != positions.shape[0]:
        raise ValueError("rotations and positions differ in length")
    return np.hstack((positions, rotations.as_quat()))


def save_in_tum_format(filename, timestamps, rotations, positions):
    """Write '<timestamp> tx ty tz qx qy qz qw' lines."""
    posevecs = convert_to_tum_poses(rotations, positions)
    with open(filename, "w") as f:
        for timestamp, posevec in zip(timestamps, posevecs):
            f.write(f"{timestamp} {' '.join(map(str, posevec.tolist()))}\n")


def load_tum_poses(path, delimiter=None):
    """Read TUM groundtruth.txt: (timestamps, Rotation, positions)."""
    array = np.loadtxt(path, delimiter=delimiter)
    return array[:, 0], Rotation.from_quat(array[:, 4:8]), array[:, 1:4]
