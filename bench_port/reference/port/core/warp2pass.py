"""Axis-aligned two-pass image warps (counterpart of
``tadataka_tpu/core/warp2pass.py``).

The Catmull-Smith decomposition of a homography into a horizontal then a
vertical 1-D resample, each written as a clipped ``torch.gather``.  It
differs from a direct 2-D bilinear warp (``grid_sample``) by the cross
term of the reconstruction filter, so only this form holds parity with
the JAX package.  ``homography_warp`` takes a batch of homographies
(..., 3, 3) and warps one image by each of them at once, or one
homography and a batch of channels (C, H, W) warped alike.
"""

import torch


def _gather(img, dim, index):
    """torch.gather with the leading dims of ``img`` and ``index``
    broadcast against each other."""
    batch = torch.broadcast_shapes(img.shape[:-2], index.shape[:-2])
    return torch.gather(img.expand(batch + img.shape[-2:]), dim,
                        index.expand(batch + index.shape[-2:]))


def gather_rows_bilinear(img, y):
    """out[..., i, j] = img interpolated at (row=y[..., i, j], col=j)."""
    H = img.shape[-2]
    yc = torch.clamp(y, 0.0, H - 1.0)
    y0 = torch.floor(yc)
    ay = yc - y0
    y0i = y0.to(torch.int64)
    y1i = torch.clamp(y0i + 1, max=H - 1)
    v0 = _gather(img, -2, y0i)
    v1 = _gather(img, -2, y1i)
    return (1.0 - ay) * v0 + ay * v1


def gather_cols_bilinear(img, x):
    """out[..., i, j] = img interpolated at (row=i, col=x[..., i, j])."""
    W = img.shape[-1]
    xc = torch.clamp(x, 0.0, W - 1.0)
    x0 = torch.floor(xc)
    ax = xc - x0
    x0i = x0.to(torch.int64)
    x1i = torch.clamp(x0i + 1, max=W - 1)
    v0 = _gather(img, -1, x0i)
    v1 = _gather(img, -1, x1i)
    return (1.0 - ax) * v0 + ax * v1


EPSILON = 1e-16


def _columns(cols, Wi, img):
    """Output column coordinates: ``cols = (x0, w)`` gives x0 .. x0+w-1,
    None the whole width."""
    x0, w = (0, Wi) if cols is None else cols
    return torch.arange(x0, x0 + w, dtype=img.dtype, device=img.device)


def homography_warp(img, H33, out_shape=None, fill=-1.0, eps=1e-6,
                    cols=None):
    """Warp ``img`` (H, W) or (C, H, W) by pixel-space homographies
    ``H33`` (..., 3, 3): out[..., y', x'] = img(U, V) with
    (U, V, 1) ~ H33 @ (x', y', 1).  ``out_shape = (Ho, Wo)`` sets the
    output grid (the image's by default).  ``cols = (x0, w)`` computes
    only the output columns x0 .. x0+w-1 (each lane's arithmetic as in
    the whole warp), still sampling the whole image.

    Returns (warped (..., Ho, Wo), valid): ``valid`` marks lanes whose
    source is inside the image and in front of the projection plane
    (D > eps); invalid lanes hold ``fill``.
    """
    Ho, Wo = img.shape[-2:] if out_shape is None else out_shape
    yo = torch.arange(Ho, dtype=img.dtype, device=img.device)[:, None]
    return _warp(img, H33, _columns(cols, Wo, img)[None, :], yo, fill, eps)


def _warp(img, H33, xo, yo, fill, eps):
    """The two-pass warp at output columns ``xo`` (1, w) and rows ``yo``
    (h, 1): pass A runs over every row of the image, pass B gathers its
    rows at the output lanes."""
    Hi, Wi = img.shape[-2:]
    f32 = img.dtype
    h = H33[..., None, None]          # broadcast each entry over (H, W)
    h00, h01, h02 = h[..., 0, 0, :, :], h[..., 0, 1, :, :], h[..., 0, 2, :, :]
    h10, h11, h12 = h[..., 1, 0, :, :], h[..., 1, 1, :, :], h[..., 1, 2, :, :]
    h20, h21, h22 = h[..., 2, 0, :, :], h[..., 2, 1, :, :], h[..., 2, 2, :, :]

    # direct maps for validity and for pass B's row coordinate
    D = h20 * xo + h21 * yo + h22
    Dz = torch.where(D == 0.0, eps, D)
    U = (h00 * xo + h01 * yo + h02) / Dz
    V = (h10 * xo + h11 * yo + h12) / Dz

    # pass A: on ref row y, place img(a(x', y), y) at column x'
    yi = torch.arange(Hi, dtype=f32, device=img.device)[:, None]
    denom_a = h11 - yi * h21
    denom_a = torch.where(torch.abs(denom_a) < eps, eps, denom_a)
    y_src = (yi * (h20 * xo + h22) - (h10 * xo + h12)) / denom_a
    D_a = h20 * xo + h21 * y_src + h22
    a = (h00 * xo + h01 * y_src + h02) / torch.where(D_a == 0.0, eps, D_a)
    tmp = gather_cols_bilinear(img, a)

    # pass B: gather rows of tmp at V
    out = gather_rows_bilinear(tmp, V)
    valid = ((D > eps) & (U >= 0.0) & (U <= Wi - 1.0)
             & (V >= 0.0) & (V <= Hi - 1.0))
    return torch.where(valid, out, fill), valid


def displacement_warp(img, dx, dy, cols=None):
    """out(x, y) ~ img(x + dx(x, y), y + dy(x, y)) for smooth, small
    displacement fields: horizontal resample, then vertical.  ``cols``:
    as in :func:`homography_warp` (dx, dy are then (H, w)).
    Returns (values, valid)."""
    Hi, Wi = img.shape
    f32 = img.dtype
    X = _columns(cols, Wi, img)[None, :] + dx
    Y = torch.arange(Hi, dtype=f32, device=img.device)[:, None] + dy
    out = gather_rows_bilinear(gather_cols_bilinear(img, X), Y)
    valid = (X >= 0.0) & (X <= Wi - 1.0) & (Y >= 0.0) & (Y <= Hi - 1.0)
    return out, valid
