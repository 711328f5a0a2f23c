from tadataka_torch.apps.dvo_trajectory import DvoTrajectory
from tadataka_torch.apps.semi_dense_vo import SemiDenseVO, SemiDenseVOState
from tadataka_torch.apps.pipelined_semi_dense import (
    PipelinedSemiDenseVO, PipelinedSemiDenseVOState)
