"""The five gather probes (``csrc/gather_probes.cu``): wrappers, plain
versions and input checks, shared by the two entry modules
``dynamic_gather`` and ``flat_gather``.

A wrapper launches its kernel on CUDA tensors and counts the launch
(``<wrapper>.launches``); on CPU tensors it runs the plain version;
anything else raises.  Semantics are JAX's: ``take_along_axis`` wraps an
index in [-n, 0) and gives NaN outside [-n, n); ``take(mode="clip")``
clamps into [0, n - 1].
"""

from pathlib import Path

import torch

from tadataka_torch.probes.exp_ssd import _device_of, _launch

_SOURCE = Path(__file__).parent / "csrc" / "gather_probes.cu"
_library = None


def gather_library():
    """Build (at first use) and load the gather kernels."""
    global _library
    if _library is None:
        import ctypes
        from tadataka_torch.cuda_build import build
        built = build(_SOURCE)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib = built.lib
        lib.take_along_axis_launch.argtypes = [ptr, ptr] + [i32] * 3 + [
            ptr, ptr]
        lib.take_along_axis0_strip_launch.argtypes = [ptr, ptr, i32, i32,
                                                      ptr, ptr]
        lib.multi_warp_launch.argtypes = [ptr] * 3 + [i32] * 4 + [ptr, ptr]
        lib.multi_warp_strip_launch.argtypes = lib.multi_warp_launch.argtypes
        lib.empty_launch.argtypes = [ptr]
        lib.take_along_axis1_row_launch.argtypes = [ptr, ptr, i32, i32, ptr,
                                                    ptr]
        lib.flat_take_launch.argtypes = [ptr, i32, ptr, i32, i32, ptr, ptr]
        lib.flat_take_band_launch.argtypes = lib.flat_take_launch.argtypes
        lib.flat_take_rows_launch.argtypes = lib.flat_take_launch.argtypes
        for fn in (lib.take_along_axis_launch,
                   lib.take_along_axis0_strip_launch, lib.multi_warp_launch,
                   lib.multi_warp_strip_launch, lib.empty_launch,
                   lib.take_along_axis1_row_launch, lib.flat_take_launch,
                   lib.flat_take_band_launch, lib.flat_take_rows_launch):
            fn.restype = i32
        _library = built
    return _library


def _check(name, img, *indices):
    if img.dim() != 2 or img.dtype != torch.float32:
        raise ValueError(f"{name} wants img (H, W) float32")
    for idx in indices:
        if idx.dtype != torch.int32:
            raise ValueError(f"{name} wants int32 indices")


def _stream():
    return torch.cuda.current_stream().cuda_stream


# ------------------------------------------------------- plain versions

def _wrapped(idx, n):
    """take_along_axis's index rule: (index in [0, n) as int64, valid)."""
    valid = (idx >= -n) & (idx < n)
    index = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1).long()
    return index, valid


def take_along_axis_reference(img, idx, axis):
    """Plain version of ``jnp.take_along_axis(img, idx, axis)``."""
    H, W = img.shape
    if axis == 0:
        rows, valid = _wrapped(idx, H)
        cols = torch.arange(W, device=img.device).expand(idx.shape)
    else:
        cols, valid = _wrapped(idx, W)
        rows = torch.arange(H, device=img.device)[:, None].expand(idx.shape)
    return torch.where(valid, img[rows, cols], float("nan"))


def multi_warp_reference(img, idxr, idxc, S):
    """Plain version of ``k_multi``: S times acc = acc + t2 (1 + s), with
    t1 = take_along_axis(img, idxc, 1), t2 = take_along_axis(t1, idxr,
    0)."""
    t2 = take_along_axis_reference(
        take_along_axis_reference(img, idxc, 1), idxr, 0)
    acc = torch.zeros_like(img)
    for s in range(S):
        acc = acc + t2 * (1.0 + s)
    return acc


def flat_take_reference(img, idx):
    """Plain version of ``jnp.take(img.ravel(), idx, mode="clip")``."""
    flat = img.reshape(-1)
    return flat[idx.clamp(0, flat.shape[0] - 1).long()]


def flat_take_rows_reference(img, idx):
    """Plain version of ``kernel_taa``: ``take_along_axis`` of the flat
    image broadcast to the index rows (wrap and NaN, not clip)."""
    flat = img.reshape(-1)
    index, valid = _wrapped(idx, flat.shape[0])
    return torch.where(valid, flat[index], float("nan"))


# ------------------------------------------------------------- wrappers

def _take_along_axis(wrapper, img, idx, axis, kernel):
    name = wrapper.__name__
    _check(name, img, idx)
    if idx.shape != img.shape:
        raise ValueError(f"{name} wants idx of img's shape")
    if _device_of(name, img, idx) == "cpu":
        return take_along_axis_reference(img, idx, axis)
    H, W = img.shape
    out = torch.empty_like(img)
    lib = gather_library().lib
    with torch.cuda.device(img.device):
        if kernel == "strip":
            status = lib.take_along_axis0_strip_launch(
                img.data_ptr(), idx.data_ptr(), H, W, out.data_ptr(),
                _stream())
        elif kernel == "row":
            status = lib.take_along_axis1_row_launch(
                img.data_ptr(), idx.data_ptr(), H, W, out.data_ptr(),
                _stream())
        else:
            status = lib.take_along_axis_launch(
                img.data_ptr(), idx.data_ptr(), H, W, axis, out.data_ptr(),
                _stream())
        _launch(name, status)
    wrapper.launches += 1
    return out


def take_along_axis0(img, idx):
    """``take_along_axis(img, idx, axis=0)`` for img (H, W) float32 and
    idx (H, W) int32: out[i, j] = img[idx[i, j], j].  On the card a
    block stages a 32-column strip of img and a band of idx in shared
    memory and gathers from there; where the strip does not fit in 227 KB
    (H past 1556 at 640 columns) the first kernel runs, one thread an
    element gathering from L2."""
    return _take_along_axis(take_along_axis0, img, idx, 0, "strip")


def take_along_axis1(img, idx):
    """``take_along_axis(img, idx, axis=1)`` for img (H, W) float32 and
    idx (H, W) int32: out[i, j] = img[i, idx[i, j]].  On the card a
    block stages a band of whole rows in shared memory and gathers from
    there; a row past 227 KB runs the first kernel, one thread an element
    (:func:`first_kernel`)."""
    return _take_along_axis(take_along_axis1, img, idx, 1, "row")


take_along_axis0.launches = 0
take_along_axis1.launches = 0


def multi_warp(img, idxr, idxc, S=16):
    """``k_multi``: S two-pass index warps of img (H, W), accumulated with
    weights 1 .. S.  The kernel runs every warp's gathers (no hoisting);
    idxr and idxc are (H, W) int32.  On the card a block stages a
    32-column strip of idxc in shared memory; where the strip does not
    fit in 227 KB (H past 1816) the first kernel runs, one thread a
    pixel."""
    _check("multi_warp", img, idxr, idxc)
    if idxr.shape != img.shape or idxc.shape != img.shape or S < 0:
        raise ValueError("multi_warp wants idxr and idxc of img's shape and "
                         "S >= 0")
    if _device_of("multi_warp", img, idxr, idxc) == "cpu":
        return multi_warp_reference(img, idxr, idxc, S)
    H, W = img.shape
    out = torch.empty_like(img)
    launch = gather_library().lib.multi_warp_strip_launch
    with torch.cuda.device(img.device):
        # stride 0: every warp's gathers run, at the same addresses
        _launch("multi_warp", launch(
            img.data_ptr(), idxr.data_ptr(), idxc.data_ptr(), H, W, S, 0,
            out.data_ptr(), _stream()))
    multi_warp.launches += 1
    return out


multi_warp.launches = 0


def _flat(wrapper, img, idx, reference, launch_name):
    name = wrapper.__name__
    _check(name, img, idx)
    if idx.dim() != 2:
        raise ValueError(f"{name} wants idx (S, N)")
    if _device_of(name, img, idx) == "cpu":
        return reference(img, idx)
    S, N = idx.shape
    out = torch.empty((S, N), dtype=torch.float32, device=img.device)
    launch = getattr(gather_library().lib, launch_name)
    with torch.cuda.device(img.device):
        _launch(name, launch(img.data_ptr(), img.numel(), idx.data_ptr(), S,
                             N, out.data_ptr(), _stream()))
    wrapper.launches += 1
    return out


def flat_take(img, idx):
    """``take(img.ravel(), idx, mode="clip")`` for idx (S, N) int32.  On
    the card each block holds a chunk of indices in registers and the
    image streams past them in bands through its shared memory,
    multicast across a cluster of 2 blocks ("band",
    csrc/gather_probes.cu); an image of H * W % 4 != 0 floats, which the
    16-byte band copies cannot move, runs the first kernel
    (:func:`first_kernel`)."""
    return _flat(flat_take, img, idx, flat_take_reference,
                 "flat_take_band_launch")


def first_kernel(wrapper, img, idx):
    """Run the first kernel of ``take_along_axis1`` or ``flat_take`` (one
    thread an element, gathering from L2), counted on the wrapper: each
    runs it where its own kernel cannot take the input, and the probes
    time it beside the wrapper at the probe shapes."""
    if wrapper is take_along_axis1:
        return _take_along_axis(take_along_axis1, img, idx, 1, "thread")
    if wrapper is flat_take:
        return _flat(flat_take, img, idx, flat_take_reference,
                     "flat_take_launch")
    raise ValueError(f"first_kernel: not for {wrapper.__name__}")


def flat_take_rows(img, idx):
    """``kernel_taa``: the gather of :func:`flat_take` through
    take_along_axis (wrap and NaN), elementwise over the S*N indices.  On
    the card each thread keeps 16 gathers in flight, reading the image
    from L2 (csrc/gather_probes.cu)."""
    return _flat(flat_take_rows, img, idx, flat_take_rows_reference,
                 "flat_take_rows_launch")


flat_take.launches = 0
flat_take_rows.launches = 0

WRAPPERS = (take_along_axis0, take_along_axis1, multi_warp, flat_take,
            flat_take_rows)


def empty_launch():
    """Launch the library's empty kernel (one block of 32 threads) on the
    current stream: timed with CUDA events, the card's floor for one
    launch.  Not counted: it computes nothing."""
    _launch("empty", gather_library().lib.empty_launch(_stream()))


def same_bits(a, b):
    """Bit-equal, with NaN in the same places (NaN payloads aside)."""
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    return torch.equal(torch.where(nan, 0, a.view(torch.int32)),
                       torch.where(nan, 0, b.view(torch.int32)))
