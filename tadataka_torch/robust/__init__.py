"""Robust M-estimator weights."""
