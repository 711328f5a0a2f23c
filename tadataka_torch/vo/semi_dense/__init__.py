"""LSD-SLAM-style semi-dense inverse-depth estimation (counterpart of
``tadataka_tpu/vo/semi_dense``): the plane-sweep update, propagation,
age and regularization of the semi-dense VO slice."""

from tadataka_torch.vo.semi_dense.params import SemiDenseParams
from tadataka_torch.vo.semi_dense.frame import (
    SemiDenseFrame, make_frame, stack_frames)
from tadataka_torch.vo.semi_dense.estimator import (
    update_depth, estimate_pixel, estimate_debug)
from tadataka_torch.vo.semi_dense.propagation import propagate
from tadataka_torch.vo.semi_dense.age import increment_age
from tadataka_torch.vo.semi_dense.fusion import fusion, fusion_maps
from tadataka_torch.vo.semi_dense.regularization import regularize
