from tadataka_torch.dataset.frame import Frame
from tadataka_torch.dataset.base import BaseDataset
from tadataka_torch.dataset.synthetic import (
    PlaneSceneDataset, default_texture, export_euroc_scene, export_tum_scene,
    multi_plane_scene, render_plane_scene)
from tadataka_torch.dataset.image_io import imread, imsave, rgb2gray
from tadataka_torch.dataset.tum_rgbd import TumRgbdDataset
from tadataka_torch.dataset.new_tsukuba import NewTsukubaDataset
from tadataka_torch.dataset.euroc import EurocDataset
