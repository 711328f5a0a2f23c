"""Gray conversion (counterpart of ``rgb2gray`` in
``tadataka_tpu/dataset/image_io.py``)."""

import numpy as np


def rgb2gray(image):
    """ITU-R 601 luma on the host, matching skimage.color.rgb2gray on
    uint8/float; a 2-D image passes through as float32."""
    image = np.asarray(image)
    if image.ndim == 2:
        return image.astype(np.float32)
    if image.dtype == np.uint8:
        image = image.astype(np.float32) / 255.0
    rgb = image[..., :3].astype(np.float32)
    return rgb @ np.array([0.2125, 0.7154, 0.0721], dtype=np.float32)
