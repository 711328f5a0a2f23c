"""Camera-model text files (counterpart of ``tadataka_tpu/camera/io.py``):
one line per camera, ``<camera_id> <Distortion> fx fy cx cy [params]``."""

from tadataka_torch.camera.model import CameraModel


def _parse_line(line):
    """Split one ``<id> <model spec>`` record into (int id, CameraModel)."""
    fields = line.split(None, 1)
    if len(fields) != 2 or not fields[0].lstrip("+-").isdigit():
        raise ValueError(f"invalid camera record {line!r}: expected "
                         "'<integer id> <model spec>'")
    return int(fields[0]), CameraModel.fromstring(fields[1])


def load(filename):
    """{camera id: CameraModel} of a camera file (blank lines skipped)."""
    camera_models = {}
    with open(filename) as f:
        for line in f:
            record = line.strip()
            if record:
                camera_id, model = _parse_line(record)
                camera_models[camera_id] = model
    return camera_models


def save(filename, camera_models):
    """Write {camera id: CameraModel}, one line each, by ascending id."""
    with open(filename, "w") as f:
        for camera_id, camera_model in sorted(camera_models.items(),
                                              key=lambda v: v[0]):
            f.write(f"{camera_id} {camera_model}\n")
