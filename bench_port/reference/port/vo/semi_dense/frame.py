"""Frame record of the semi-dense pipeline (counterpart of
``tadataka_tpu/vo/semi_dense/frame.py``); a stack of frames carries a
leading refframe axis R on every field."""

from typing import NamedTuple

import torch


class SemiDenseFrame(NamedTuple):
    focal_length: torch.Tensor   # (2,) or (R, 2)
    offset: torch.Tensor         # (2,) or (R, 2)
    image: torch.Tensor          # (H, W) or (R, H, W)
    transform_wf: torch.Tensor   # (4, 4) or (R, 4, 4)


def make_frame(camera_params, image, transform_wf):
    return SemiDenseFrame(camera_params.focal_length, camera_params.offset,
                          image, transform_wf)


def stack_frames(frames):
    return SemiDenseFrame(*(torch.stack(fields) for fields in zip(*frames)))


def normalize(frame, us):
    """Pixel coords (..., 2) of ``frame`` -> its normalized image plane."""
    return (us - frame.offset) / frame.focal_length


def unnormalize(frame, xs):
    return xs * frame.focal_length + frame.offset
