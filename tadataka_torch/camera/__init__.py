from tadataka_torch.camera.parameters import CameraParameters
from tadataka_torch.camera.model import CameraModel, NoDistortion, resize
