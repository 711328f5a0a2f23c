"""CameraModel: intrinsics + distortion (counterpart of
``tadataka_tpu/camera/model.py``).  Only ``NoDistortion`` is ported; FOV
and RadTan are ROADMAP work and ``create`` refuses them."""

from typing import Any, NamedTuple

from tadataka_torch.camera.parameters import CameraParameters


class NoDistortion(NamedTuple):
    def distort_xy(self, u, v):
        return u, v

    def undistort_xy(self, u, v):
        return u, v

    def distort(self, x):
        return x

    def undistort(self, x):
        return x


class CameraModel(NamedTuple):
    camera_parameters: CameraParameters
    distortion_model: Any

    @classmethod
    def create(cls, camera_parameters, distortion_model=None):
        if distortion_model is None:
            distortion_model = NoDistortion()
        if not isinstance(distortion_model, NoDistortion):
            raise NotImplementedError(
                f"{type(distortion_model).__name__} distortion is not ported "
                "yet (ROADMAP Queue 1: FOV/RadTan)")
        return cls(camera_parameters, distortion_model)

    def normalize(self, keypoints):
        return self.distortion_model.undistort(
            self.camera_parameters.normalize(keypoints))

    def unnormalize(self, normalized_keypoints):
        return self.camera_parameters.unnormalize(
            self.distortion_model.distort(normalized_keypoints))

    def normalize_xy(self, ux, uy):
        return self.distortion_model.undistort_xy(
            *self.camera_parameters.normalize_xy(ux, uy))

    def unnormalize_xy(self, xn, yn):
        return self.camera_parameters.unnormalize_xy(
            *self.distortion_model.distort_xy(xn, yn))


def resize(cm, scale):
    """Scale intrinsics for a pyramid level (distortion is scale-invariant)."""
    p = cm.camera_parameters
    return CameraModel(
        CameraParameters(p.focal_length * scale, p.offset * scale),
        cm.distortion_model)
