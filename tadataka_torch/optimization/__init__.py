from tadataka_torch.optimization.framework import (
    Function, BaseResidual, SumRobustifiedNormError,
    SquaredRobustifier, GemanMcClureRobustifier,
    GaussNewtonUpdater, Optimizer)
