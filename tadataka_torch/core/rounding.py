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
  :func:`sqrt` takes the CPU's root in float64, rounds it to float32
  and corrects it against the exact squares of the rounding midpoints.
- ``torch.tan`` and ``torch.atan`` round by device library.  :func:`tan`
  and :func:`atan` reduce the argument and sum a Taylor polynomial in
  float64 with elementwise products, sums and true divisions, each
  correctly rounded by IEEE on every device, then round to float32.

Sums over many elements go through :func:`fixed_order_sum`, one
pairwise order on every device.
"""

import math

import torch
import torch.nn.functional as F

# pi/2 split for the reduction of tan (fdlibm's pio2_1 and pio2_1t):
# _PIO2_HI has 33 significant bits, so k * _PIO2_HI is exact for
# |k| < 2^20, and _PIO2_HI + _PIO2_LO is pi/2 within 4e-27
_PIO2_HI = 1.57079632673412561417e+00
_PIO2_LO = 6.07710050650619224932e-11
_2_OVER_PI = 2.0 / math.pi
# Taylor coefficients past the first term: sin r = r + r z S(z), cos r =
# 1 + z C(z) with z = r^2; on |r| <= pi/4 the first omitted terms are
# below 5e-17 of the result
_SIN = [(-1) ** n / math.factorial(2 * n + 1) for n in range(1, 8)]
_COS = [(-1) ** n / math.factorial(2 * n) for n in range(1, 9)]
# atan t = t + t z A(z) on |t| <= 1/16 (omitted terms below 1e-18 of t),
# around the table atan(j / 8), j = 0 .. 8
_ATAN = [(-1) ** n / (2 * n + 1) for n in range(1, 7)]
_ATAN_TABLE = [math.atan(j / 8) for j in range(9)]
_atan_tables = {}   # device -> _ATAN_TABLE as a float64 tensor there


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
        return _corrected_sqrt(x)
    return torch.sqrt(x)


def _corrected_sqrt(x):
    """The CPU's float64 root rounded to float32, then moved by an ulp
    where it lies past a midpoint to a float32 neighbour.  The CPU's
    float64 root is not always correctly rounded, nor the same on a
    process's first call, so it is checked against the exact squares of
    the midpoints (25 significant bits each, 50 in the square: exact in
    float64); a float32 root is never a midpoint's square."""
    xd = x.double()
    f = torch.sqrt(xd).to(x.dtype)
    down = torch.nextafter(f, torch.full_like(f, -float("inf")))
    up = torch.nextafter(f, torch.full_like(f, float("inf")))
    below = (f.double() + down.double()) * 0.5
    above = (f.double() + up.double()) * 0.5
    positive = f > 0.0
    f = torch.where(positive & (xd < below * below), down, f)
    return torch.where(positive & (xd > above * above), up, f)


def _horner(z, coeffs):
    """coeffs[0] + z (coeffs[1] + z (...)), each product and sum
    rounded on its own."""
    out = torch.full_like(z, coeffs[-1])
    for c in reversed(coeffs[:-1]):
        out = out * z + c
    return out


def tan(x):
    """tan of a float32 tensor, the same bits on every device: the
    argument reduced by k pi/2 in float64 (accurate for |x| < 2^20
    pi/2), sin and cos of the remainder r (|r| <= pi/4) by their Taylor
    polynomials, s / c (or -c / s for odd k), rounded to float32.
    Within one float32 ulp of the correctly rounded tan; odd (tan(-x)
    = -tan(x), -0 kept)."""
    a = x.abs().double()
    k = torch.round(a * _2_OVER_PI)
    r = (a - k * _PIO2_HI) - k * _PIO2_LO
    z = r * r
    s = r + (r * z) * _horner(z, _SIN)
    c = 1.0 + z * _horner(z, _COS)
    odd = (k - 2.0 * torch.floor(k * 0.5)) != 0.0
    t = torch.where(odd, -(c / s), s / c)
    return torch.where(torch.signbit(x), -t, t).to(x.dtype)


def atan(x):
    """atan of a float32 tensor, the same bits on every device: b = |x|
    or 1 / |x| (whichever is at most 1), atan b = atan(j/8) + atan(t)
    with j = round(8 b) and t = (b - j/8) / (1 + b j/8) (|t| <= 1/16)
    by its Taylor polynomial, pi/2 - atan b where |x| > 1, all in
    float64 with true divisions, rounded to float32.  Within one
    float32 ulp of the correctly rounded atan; odd, atan(+-inf) =
    +-pi/2."""
    a = x.abs().double()
    big = a > 1.0
    b = torch.where(big, torch.ones_like(a) / a, a)
    j = torch.round(torch.where(b <= 1.0, b, 0.0) * 8.0)   # NaN: j = 0
    c = j * 0.125
    t = (b - c) / (1.0 + b * c)
    z = t * t
    table = _atan_tables.get(a.device)
    if table is None:
        table = _atan_tables[a.device] = torch.tensor(
            _ATAN_TABLE, dtype=torch.float64, device=a.device)
    y = table[j.long()] + (t + (t * z) * _horner(z, _ATAN))
    y = torch.where(big, math.pi / 2 - y, y)
    return torch.where(torch.signbit(x), -y, y).to(x.dtype)


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
