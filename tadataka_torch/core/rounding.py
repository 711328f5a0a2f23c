"""Arithmetic that rounds the same on the CPU and on the card.

Three PyTorch forms differ between devices in the last bit, and on the
mapping path a last bit can move an SSD argmin by a plane:

- ``tensor / python_number`` on a CUDA tensor multiplies by the
  reciprocal (126 of the 256 values u8 / 255 then differ from the CPU's
  true quotient).  :func:`as_divisor` makes the divisor a 0-d tensor on
  the dividend's device, which both devices divide by exactly.
- ``A @ B`` goes to BLAS or cuBLAS, which fuse multiply-adds and order
  their sums their own way.  :func:`matmul_small` sums the products of
  small matrices left to right, each rounded on its own.
- ``torch.sqrt`` on the CPU (its vectorized float32 root) is one ulp off
  on about 0.6% of inputs; the card's is correctly rounded.
  :func:`sqrt` takes the CPU's root in float64, which rounds to the
  correctly rounded float32 root.

Sums over many elements go through :func:`fixed_order_sum`, one
pairwise order on every device.
"""

import torch
import torch.nn.functional as F


def as_divisor(value, like):
    """``value`` as a 0-d tensor of ``like``'s dtype and device."""
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)


def fixed_order_sum(x):
    """Sums of x (k, n) over its last axis, halving it pairwise with
    elementwise adds: the same order, and so the same bits, on every
    device (``torch.sum`` and matrix products order their sums by
    device)."""
    n = x.shape[-1]
    x = F.pad(x, (0, (1 << (n - 1).bit_length()) - n))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def matmul_small(A, B):
    """A (..., n, k) @ B (..., k, m) for a small k, as broadcast products
    summed left to right: each product and each sum rounds on its own,
    so every device gives the same bits."""
    out = A[..., :, :1] * B[..., :1, :]
    for i in range(1, A.shape[-1]):
        out = out + A[..., :, i:i + 1] * B[..., i:i + 1, :]
    return out


def sqrt(x):
    """Correctly rounded float32 square root on every device."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).to(x.dtype)
    return torch.sqrt(x)


def cross3(a, b):
    """a (..., 3) x b (..., 3), each component a rounded difference of
    rounded products."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def norm3(v):
    """Euclidean norm of v (..., 3): squares summed left to right, then
    the correctly rounded root."""
    return sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                + v[..., 2] * v[..., 2])


def inv3(A):
    """Inverse of a 3x3 matrix A (..., 3, 3): the adjugate divided by the
    determinant, in a fixed order and with true division, so that every
    device gives the same bits (a LAPACK or cuBLAS inverse does not)."""
    c0 = cross3(A[..., 1, :], A[..., 2, :])     # columns of the adjugate
    c1 = cross3(A[..., 2, :], A[..., 0, :])
    c2 = cross3(A[..., 0, :], A[..., 1, :])
    det = (A[..., 0, 0] * c0[..., 0] + A[..., 0, 1] * c0[..., 1]
           + A[..., 0, 2] * c0[..., 2])
    return torch.stack([c0, c1, c2], -1) / det[..., None, None]
