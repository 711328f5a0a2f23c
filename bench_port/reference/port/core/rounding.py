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
- ``torch.sin``, ``cos``, ``tan``, ``atan`` and ``atan2`` round by
  device library.  :func:`sin`, :func:`cos`, :func:`tan`, :func:`atan`
  and :func:`atan2` reduce the argument and sum a Taylor polynomial in
  float64 with elementwise products, sums and true divisions, each
  correctly rounded by IEEE on every device, then round to float32.
  They are differentiable under ``torch.func.jacfwd`` and ``vmap``.

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
    """``value`` as a 0-d tensor of ``like``'s dtype and device, filled
    there (a copy from the host would synchronize the card)."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


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


def sum_small(x):
    """Sums of x (..., k) over its last axis for a small k, left to
    right, each sum rounded on its own."""
    out = x[..., 0]
    for i in range(1, x.shape[-1]):
        out = out + x[..., i]
    return out


def mean(x, dim):
    """Mean of x over a short ``dim`` (a few points): the sum left to
    right (:func:`sum_small`, the JAX package's order for so few)
    divided by the count (a true division on every device)."""
    total = sum_small(x.movedim(dim, -1))
    return total / as_divisor(x.shape[dim], total)


def norm(v):
    """Euclidean norm of v (..., k) over its last axis (small k): the
    squares summed left to right, then the correctly rounded root."""
    return sqrt(sum_small(v * v))


def dot(a, b):
    """Sums of a * b over the last axis (small), left to right."""
    return sum_small(a * b)


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


def sqrt_positive(x):
    """:func:`sqrt` of x > 0 with a derivative under ``torch.func``
    transforms: the value is the correctly rounded root, and a tangent
    t becomes t * (0.5 / root), the same bits on every device (the
    root's own CPU form has no derivative)."""
    root = sqrt(x.detach())
    scaled = x * (as_divisor(0.5, root) / root)
    return root + (scaled - scaled.detach())


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


def _sin_cos_reduced(x):
    """(sin r, cos r, q) in float64 for x = r + k pi/2, |r| <= pi/4 and
    q = k mod 4 (the argument reduced as in :func:`tan`, signed, so that
    forward-mode derivatives pass through r)."""
    xd = x.double()
    k = torch.round(xd * _2_OVER_PI)
    r = (xd - k * _PIO2_HI) - k * _PIO2_LO
    z = r * r
    return (r + (r * z) * _horner(z, _SIN), 1.0 + z * _horner(z, _COS),
            torch.remainder(k, 4.0))


def _quadrant(q, first, second):
    """The value in quadrant q (0..3) of a function that is ``first`` in
    quadrant 0, ``second`` in quadrant 1 and their negatives in 2 and 3."""
    return torch.where(q == 0.0, first, torch.where(
        q == 1.0, second, torch.where(q == 2.0, -first, -second)))


def sincos(x):
    """(sin x, cos x) of a float32 tensor from one reduction, the same
    bits as :func:`sin` and :func:`cos`."""
    s, c, q = _sin_cos_reduced(x)
    # sin(+-0) = +-0 (the reduction gives r = +0 for x = -0)
    return (torch.where(x == 0.0, x, _quadrant(q, s, c).to(x.dtype)),
            _quadrant(q, c, -s).to(x.dtype))


def sin(x):
    """sin of a float32 tensor, the same bits on every device: sin(r + k
    pi/2) is sin r, cos r, -sin r or -cos r by k mod 4, rounded to
    float32 (accurate for |x| < 2^20 pi/2).  Within one float32 ulp of
    the correctly rounded sin; its derivative (cos r, ... through r) is
    within one ulp of cos x."""
    return sincos(x)[0]


def cos(x):
    """cos of a float32 tensor, the same bits on every device (see
    :func:`sin`): cos r, -sin r, -cos r or sin r by k mod 4."""
    return sincos(x)[1]


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


def _atan_unit(b):
    """atan b in float64 for float64 b in [0, 1] (NaN: NaN): atan(j/8) +
    atan(t) with j = round(8 b) and t = (b - j/8) / (1 + b j/8) (|t| <=
    1/16) by its Taylor polynomial."""
    j = torch.round(torch.where(b <= 1.0, b, 0.0) * 8.0)   # NaN: j = 0
    c = j * 0.125
    t = (b - c) / (1.0 + b * c)
    z = t * t
    table = _atan_tables.get(b.device)
    if table is None:
        table = _atan_tables[b.device] = torch.tensor(
            _ATAN_TABLE, dtype=torch.float64, device=b.device)
    return table[j.long()] + (t + (t * z) * _horner(z, _ATAN))


def atan(x):
    """atan of a float32 tensor, the same bits on every device: atan b of
    b = |x| or 1 / |x| (whichever is at most 1) by :func:`_atan_unit`,
    pi/2 - atan b where |x| > 1, all in float64 with true divisions,
    rounded to float32.  Within one float32 ulp of the correctly
    rounded atan; odd, atan(+-inf) = +-pi/2."""
    a = x.abs().double()
    big = a > 1.0
    y = _atan_unit(torch.where(big, torch.ones_like(a) / a, a))
    y = torch.where(big, math.pi / 2 - y, y)
    return torch.where(torch.signbit(x), -y, y).to(x.dtype)


def atan2(y, x):
    """atan2 of float32 tensors, the same bits on every device: the
    angle of (x, y) from atan b of b = min(|x|, |y|) / max(|x|, |y|) in
    float64 (:func:`_atan_unit`), taken to its octant, rounded to
    float32.  Within one float32 ulp of the correctly rounded atan2;
    atan2(+-0, x) is +-0 for x >= +0 and +-pi for x <= -0, as IEEE
    has it."""
    yd, xd = y.double(), x.double()
    ay, ax = yd.abs(), xd.abs()
    steep = ay > ax
    num = torch.where(steep, ax, ay)
    den = torch.where(steep, ay, ax)
    b = torch.where(den == 0.0, torch.zeros_like(den), num / den)
    a = _atan_unit(b)
    a = torch.where(steep, math.pi / 2 - a, a)
    a = torch.where(torch.signbit(xd), math.pi - a, a)
    return torch.where(torch.signbit(yd), -a, a).to(y.dtype)


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
