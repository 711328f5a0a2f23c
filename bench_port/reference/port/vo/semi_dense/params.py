"""Semi-dense estimator parameters (counterpart of
``tadataka_tpu/vo/semi_dense/params.py``): 0-d float32 tensors on the
device, so every use rounds exactly as the JAX package's f32 arrays do."""

from typing import NamedTuple

import torch


class SemiDenseParams(NamedTuple):
    min_inv_depth: torch.Tensor
    max_inv_depth: torch.Tensor
    geo_coeff: torch.Tensor
    photo_coeff: torch.Tensor
    ref_step_size: torch.Tensor
    min_gradient: torch.Tensor

    @classmethod
    def create(cls, min_depth, max_depth, geo_coeff=0.01, photo_coeff=0.01,
               ref_step_size=0.01, min_gradient=0.2, dtype=torch.float32,
               device="cpu"):
        def as_t(v):
            return torch.tensor(v, dtype=dtype, device=device)
        return cls(
            min_inv_depth=as_t(1.0 / max_depth),
            max_inv_depth=as_t(1.0 / min_depth),
            geo_coeff=as_t(geo_coeff),
            photo_coeff=as_t(photo_coeff),
            ref_step_size=as_t(ref_step_size),
            min_gradient=as_t(min_gradient),
        )


N_KEY_SAMPLES = 5          # key patch: steps -2..2
DEFAULT_N_REF_SAMPLES = 64  # cap of the scattered epipolar search length
