from tadataka_torch.dataset.synthetic import (
    Frame, PlaneSceneDataset, multi_plane_scene, render_plane_scene)
from tadataka_torch.dataset.image_io import rgb2gray
