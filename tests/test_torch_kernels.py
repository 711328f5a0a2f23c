"""The port's hand-written CUDA kernels against their plain PyTorch
versions, and the wrappers' input checks.

This file imports no JAX, so it runs on a machine with a card without
``tests/conftest.py`` (which imports JAX):

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda

Without a CUDA device the ``cuda`` tests skip (a kernel has no CPU form).
"""

import numpy as np
import pytest
import torch

from tadataka_torch.vo.semi_dense.sweep import (
    ssd_search, ssd_search_reference)

SSD_CASES = ["planted", "window_mask", "invalid_samples", "ties",
             "all_invalid", "ragged_rows"]


def ssd_case(case, S, seed=7):
    """(V, K, mlo, mhi) float32 numpy inputs of one SSD search case."""
    gen = np.random.default_rng(seed)
    H, W = (13, 37) if case == "ragged_rows" else (8, 64)
    V = gen.random((S, H, W)).astype(np.float32)
    M = S - 4
    K = V[6:11].copy()                                  # planted at m = 6
    mlo = np.zeros((H, W), np.float32)
    mhi = np.full((H, W), float(M - 1), np.float32)
    if case == "window_mask":
        mlo = gen.integers(0, M // 2, (H, W)).astype(np.float32)
        mhi = mlo + gen.integers(0, M // 2, (H, W)).astype(np.float32)
    elif case == "invalid_samples":
        V[gen.random(V.shape) < 0.2] = -1.0
    elif case == "ties":
        V[S - 5:] = V[6:11]           # the same window at m = 6 and M - 1
        V[:, :, :8] = 0.5             # constant columns: every window ties
    elif case == "all_invalid":
        V[:, :4] = -1.0               # rows with no valid sample at all
        mlo[4:6], mhi[4:6] = 1e9, -1e9   # rows with an empty window range
    elif case == "ragged_rows":
        V[gen.random(V.shape) < 0.2] = -1.0
        mlo = gen.integers(0, M // 2, (H, W)).astype(np.float32)
        mhi = mlo + 3.0 + gen.integers(0, M // 2, (H, W)).astype(np.float32)
    return V, K, mlo, mhi


def tensors(arrays, device="cpu", dtype=torch.float32):
    return [torch.tensor(a, dtype=dtype, device=device) for a in arrays]


def test_ssd_search_rejects_bad_input():
    V, K, mlo, mhi = tensors(ssd_case("planted", 16))
    with pytest.raises(ValueError, match="K.shape"):
        ssd_search(V, K[:4], mlo, mhi)
    with pytest.raises(ValueError, match="S >= 5"):
        ssd_search(V[:4], K, mlo, mhi)
    with pytest.raises(TypeError, match="float32"):
        ssd_search(V.double(), K, mlo, mhi)
    with pytest.raises(ValueError, match="mlo"):
        ssd_search(V, K, mlo[:, 1:], mhi)


def test_ssd_search_cpu_runs_the_plain_version_uncounted():
    args = tensors(ssd_case("invalid_samples", 16))
    before = ssd_search.launches
    for out, ref in zip(ssd_search(*args), ssd_search_reference(*args)):
        assert torch.equal(out, ref)
    assert ssd_search.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("S", [16, 48])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_kernel_bit_equal_to_plain(case, S):
    """On the card: the CUDA kernel against the plain version on the same
    CUDA tensors, bit for bit, and one launch counted per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    args = tensors(ssd_case(case, S), device="cuda")
    before = ssd_search.launches
    out = ssd_search(*args)
    ref = ssd_search_reference(*args)
    torch.cuda.synchronize()
    assert ssd_search.launches == before + 1
    for port, plain in zip(out, ref):
        assert port.device.type == "cuda"
        assert torch.equal(port, plain)
