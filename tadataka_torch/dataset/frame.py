"""Frame record emitted by every dataset (counterpart of
``tadataka_tpu/dataset/frame.py``)."""

from typing import Any, NamedTuple


class Frame(NamedTuple):
    camera_model: Any
    pose: Any       # Pose, camera -> world
    image: Any      # (H, W) gray or (H, W, 3) rgb
    depth_map: Any  # (H, W)
