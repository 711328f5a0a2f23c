"""The yardstick of a kernel's roofline share: the card's data-sheet
peaks and the bytes and operations that an SSD window search's inputs
need, whatever design runs it.

Frozen copies of chip_smoke.py's ``bound`` and ``search_work`` and of
``ssd_window_bounds`` (tadataka_torch/vo/semi_dense/sweep.py): 4 B a
float of planes m_lo .. m_hi + 4 and of the key patch where a pixel's
window range is not empty, mlo, mhi and the four outputs everywhere,
and 24 float operations a window in range."""

import torch

# NVIDIA H100 SXM data sheet: HBM bandwidth and float32 outside the
# tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
N_KEY_SAMPLES = 5
SSD_FLOPS_PER_WINDOW = 24


def bound_s(n_bytes, flops):
    """The least time the card could take: bytes at its bandwidth or
    operations at its float32 rate, whichever is longer."""
    return max(n_bytes / PEAK_BYTES_PER_S, flops / PEAK_F32_PER_S)


def window_bounds(mlo, mhi, S):
    M = S - N_KEY_SAMPLES + 1
    nan = torch.isnan(mlo) | torch.isnan(mhi)
    lo = torch.clamp(torch.ceil(mlo), 0.0, float(M))
    hi = torch.clamp(torch.floor(mhi), -1.0, float(M - 1))
    return (torch.where(nan, float(M), lo).to(torch.int64),
            torch.where(nan, -1.0, hi).to(torch.int64))


def ssd_search_work(V, mlo, mhi):
    """(bytes, float operations) one search needs at these inputs."""
    S = V.shape[0]
    lo, hi = (x.ravel() for x in window_bounds(mlo, mhi, S))
    live = lo <= hi
    windows = int(torch.where(live, hi - lo + 1, 0).sum())
    planes = int(torch.where(live, hi - lo + N_KEY_SAMPLES, 0).sum())
    n_live = int(live.sum())
    N = lo.numel()
    return 4 * (planes + N_KEY_SAMPLES * n_live + 6 * N), \
        SSD_FLOPS_PER_WINDOW * windows
