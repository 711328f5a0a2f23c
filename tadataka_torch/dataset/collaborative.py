"""Collaborative-style dataset (counterpart of
``tadataka_tpu/dataset/collaborative.py``): a flat directory of
``<timestamp>.color.png`` / ``<timestamp>.depth.png`` pairs, read with
the port's PNG codec; depth is the 16-bit PNG over ``depth_factor``."""

import re
from pathlib import Path

import numpy as np
import torch

from tadataka_torch.dataset.base import BaseDataset
from tadataka_torch.dataset.frame import Frame
from tadataka_torch.dataset.image_io import imread


def extract_timestamp(filename):
    return int(re.findall(r"\d+", filename)[0])


class CollaborativeDataset(BaseDataset):
    def __init__(self, dataset_root, camera_model=None, depth_factor=1000.0):
        self.dataset_root = Path(dataset_root)
        self.camera_model = camera_model
        self.depth_factor = depth_factor
        color = {extract_timestamp(p.name): p
                 for p in sorted(self.dataset_root.glob("*.color.png"))}
        depth = {extract_timestamp(p.name): p
                 for p in sorted(self.dataset_root.glob("*.depth.png"))}
        self.timestamps = sorted(set(color) & set(depth))
        self.paths = [(color[t], depth[t]) for t in self.timestamps]
        self.length = len(self.paths)

    def load(self, index):
        color_path, depth_path = self.paths[index]
        image = imread(color_path)
        depth = imread(depth_path).astype(np.float32) / self.depth_factor
        return Frame(self.camera_model, None, torch.from_numpy(image),
                     torch.from_numpy(depth))
