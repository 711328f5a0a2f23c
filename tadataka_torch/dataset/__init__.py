from tadataka_torch.dataset.frame import Frame
from tadataka_torch.dataset.synthetic import (
    PlaneSceneDataset, export_tum_scene, multi_plane_scene,
    render_plane_scene)
from tadataka_torch.dataset.image_io import imread, imsave, rgb2gray
from tadataka_torch.dataset.tum_rgbd import TumRgbdDataset
