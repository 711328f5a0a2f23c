from bench_port.reference.port.camera.parameters import CameraParameters  # noqa: F401
from bench_port.reference.port.camera.distortion import FOV, NoDistortion, RadTan  # noqa: F401
from bench_port.reference.port.camera.model import CameraModel, resize  # noqa: F401
