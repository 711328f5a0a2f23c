"""Image gradients (counterpart of ``tadataka_tpu/core/gradients.py``):
Sobel (zero or edge border) and np.gradient, both as shifted adds.  No
convolution: a float32 convolution on the card would run through cuDNN
in TF32."""

import torch
import torch.nn.functional as F


def _sobel_x_valid(image):
    """VALID-region Sobel d/dx via the separable [1,2,1]^T (x) [-1,0,1]."""
    dx = image[:, 2:] - image[:, :-2]
    return dx[:-2] + 2.0 * dx[1:-1] + dx[2:]


def _sobel_y_valid(image):
    dy = image[2:, :] - image[:-2, :]
    return dy[:, :-2] + 2.0 * dy[:, 1:-1] + dy[:, 2:]


def sobel_x(image, mode="zero"):
    """d/dx Sobel (unnormalized, 4x the central difference).  mode="zero":
    zero border; mode="reflect": scipy.ndimage's border (the edge sample
    repeated)."""
    return _apply_sobel(image, _sobel_x_valid, mode)


def sobel_y(image, mode="zero"):
    return _apply_sobel(image, _sobel_y_valid, mode)


def _apply_sobel(image, valid_fn, mode):
    if mode == "zero":
        return F.pad(valid_fn(image), (1, 1, 1, 1))
    if mode == "reflect":
        padded = F.pad(image[None, None], (1, 1, 1, 1), mode="replicate")
        return valid_fn(padded[0, 0])
    raise ValueError(f"unknown border mode {mode!r}")


def grad_x(image):
    """scipy.ndimage.sobel(image, axis=1, mode="reflect")."""
    return sobel_x(image, mode="reflect")


def grad_y(image):
    """scipy.ndimage.sobel(image, axis=0, mode="reflect")."""
    return sobel_y(image, mode="reflect")


def _central_diff(a, dim):
    """Central differences along ``dim`` with one-sided edges."""
    a = a.movedim(dim, 0)
    out = torch.empty_like(a)
    out[1:-1] = (a[2:] - a[:-2]) / 2.0
    out[0] = a[1] - a[0]
    out[-1] = a[-1] - a[-2]
    return out.movedim(0, dim)


def np_gradient_2d(image):
    """np.gradient for 2-D images, returned as (DX, DY)."""
    return _central_diff(image, 1), _central_diff(image, 0)


def gradient1d(x):
    """Forward differences along the last axis: x[1:] - x[:-1]."""
    return x[..., 1:] - x[..., :-1]
