from tadataka_torch.vo.dvo import PoseChangeEstimator  # noqa: F401
