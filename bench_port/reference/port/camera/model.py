"""CameraModel: intrinsics + distortion, with the text form
"<Distortion> fx fy cx cy [params]" (counterpart of
``tadataka_tpu/camera/model.py``).  normalize = undistort(normalize(u)),
unnormalize = unnormalize(distort(x))."""

import re
from typing import Any, NamedTuple

from bench_port.reference.port.camera.distortion import FOV, NoDistortion, RadTan
from bench_port.reference.port.camera.parameters import CameraParameters


class CameraModel(NamedTuple):
    camera_parameters: CameraParameters
    distortion_model: Any   # NoDistortion | FOV | RadTan

    @classmethod
    def create(cls, camera_parameters, distortion_model=None):
        if distortion_model is None:
            distortion_model = NoDistortion()
        return cls(camera_parameters, distortion_model)

    def normalize(self, keypoints):
        """Pixel coords -> undistorted normalized image plane."""
        return self.distortion_model.undistort(
            self.camera_parameters.normalize(keypoints))

    def unnormalize(self, normalized_keypoints):
        """Normalized image plane -> (distorted) pixel coords."""
        return self.camera_parameters.unnormalize(
            self.distortion_model.distort(normalized_keypoints))

    def normalize_xy(self, ux, uy):
        return self.distortion_model.undistort_xy(
            *self.camera_parameters.normalize_xy(ux, uy))

    def unnormalize_xy(self, xn, yn):
        return self.camera_parameters.unnormalize_xy(
            *self.distortion_model.distort_xy(xn, yn))

    def to(self, device):
        """The same model with every tensor on ``device``."""
        p = self.camera_parameters
        return CameraModel(
            CameraParameters(p.focal_length.to(device), p.offset.to(device)),
            type(self.distortion_model)(
                *(x.to(device) for x in self.distortion_model)))

    def __str__(self):
        distortion_type = type(self.distortion_model).__name__
        params = self.camera_parameters.params + self.distortion_model.params
        return " ".join([distortion_type] + [repr(float(v)) for v in params])

    @staticmethod
    def fromstring(string):
        parts = re.split(r"\s+", string.strip())
        distortion_type = parts[0]
        params = [float(v) for v in parts[1:]]
        camera_parameters = CameraParameters.from_params(params[0:4])
        dist_params = params[4:]
        if distortion_type == "FOV":
            distortion = FOV.from_params(dist_params)
        elif distortion_type == "RadTan":
            distortion = RadTan.from_params(dist_params)
        elif distortion_type == "NoDistortion":
            distortion = NoDistortion()
        else:
            raise ValueError(f"Unknown distortion model: {distortion_type}")
        return CameraModel(camera_parameters, distortion)


def resize(cm, scale):
    """Scale intrinsics for a pyramid level (distortion is scale-invariant)."""
    p = cm.camera_parameters
    return CameraModel(
        CameraParameters(p.focal_length * scale, p.offset * scale),
        cm.distortion_model)
