from tadataka_torch.camera.parameters import CameraParameters
from tadataka_torch.camera.distortion import FOV, NoDistortion, RadTan
from tadataka_torch.camera.model import CameraModel, resize
from tadataka_torch.camera.io import load, save
from tadataka_torch.camera.table import NormalizationMapTable
