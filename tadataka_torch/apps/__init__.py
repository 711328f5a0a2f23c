from tadataka_torch.apps.semi_dense_vo import SemiDenseVO, SemiDenseVOState
