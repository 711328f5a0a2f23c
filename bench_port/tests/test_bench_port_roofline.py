"""The frozen yardstick of ssd_search's roofline share against hand
counts."""

import math

import pytest
import torch

from bench_port.harness.roofline import (
    PEAK_BYTES_PER_S, PEAK_F32_PER_S, bound_s, ssd_search_work,
    window_bounds)


def test_window_bounds_clamp_and_nan():
    S = 9                                    # M = 5 windows
    mlo = torch.tensor([[-3.0, 0.5, 2.0, float("nan")]])
    mhi = torch.tensor([[10.0, 2.5, 1.0, 3.0]])
    lo, hi = window_bounds(mlo, mhi, S)
    assert lo.tolist() == [[0, 1, 2, 5]]
    assert hi.tolist() == [[4, 2, 1, -1]]


def test_bytes_and_flops_by_hand():
    S, H, W = 9, 1, 4
    V = torch.zeros((S, H, W))
    mlo = torch.tensor([[-3.0, 0.5, 2.0, float("nan")]])
    mhi = torch.tensor([[10.0, 2.5, 1.0, 3.0]])
    n_bytes, flops = ssd_search_work(V, mlo, mhi)
    # pixel 0: windows 0..4 (5 windows, planes 0..8 = 9); pixel 1:
    # windows 1..2 (2 windows, planes 1..6 = 6); pixels 2, 3: none
    planes, live, windows = 9 + 6, 2, 5 + 2
    assert n_bytes == 4 * (planes + 5 * live + 6 * H * W)
    assert flops == 24 * windows


def test_full_range_counts_every_plane_once():
    S, H, W = 48, 3, 5
    V = torch.zeros((S, H, W))
    mlo = torch.full((H, W), -1.0)
    mhi = torch.full((H, W), 1e9)
    n_bytes, flops = ssd_search_work(V, mlo, mhi)
    assert n_bytes == 4 * (S + 5 + 6) * H * W
    assert flops == 24 * (S - 4) * H * W


def test_bound_is_the_slower_of_bytes_and_operations():
    assert bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert bound_s(0, 67e12) == pytest.approx(1.0)
    assert bound_s(1e9, 1e9) == pytest.approx(
        max(1e9 / PEAK_BYTES_PER_S, 1e9 / PEAK_F32_PER_S))
    assert not math.isnan(bound_s(0, 0))
