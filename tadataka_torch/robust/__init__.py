"""Robust M-estimator weights."""
from tadataka_torch.robust.weights import (  # noqa: F401
    compute_weights_tukey, compute_weights_huber, compute_weights_student_t)
