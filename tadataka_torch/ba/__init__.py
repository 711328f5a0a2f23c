from tadataka_torch.ba.residuals import transform_project, projection_residuals
from tadataka_torch.ba.schur import lm_solve, LocalBundleAdjustment
from tadataka_torch.ba.api import run_ba, try_run_ba, can_run_ba
