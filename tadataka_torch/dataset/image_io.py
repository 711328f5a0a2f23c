"""Image file IO and gray conversion (counterpart of
``tadataka_tpu/dataset/image_io.py``).

PNG is read and written by a codec of this module, on ``zlib`` and
numpy alone, so the port needs no imaging package.  It handles the
formats of the datasets: 8-bit gray, 8-bit RGB, 8-bit RGBA and 16-bit
gray (stored big-endian, returned as native uint16), non-interlaced.
Reading undoes all five row filters; writing uses filter 0 (None) on
every row.
"""

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# (color type, bit depth) -> (channels, numpy dtype)
_FORMATS = {(0, 8): (1, np.uint8), (2, 8): (3, np.uint8),
            (6, 8): (4, np.uint8), (0, 16): (1, np.dtype(">u2"))}


def _chunks(data):
    """(type, payload) of each chunk after the signature, CRC checked."""
    pos = len(_SIGNATURE)
    while pos + 12 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        payload = data[pos + 8:pos + 8 + length]
        crc, = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        yield kind, payload
        pos += 12 + length


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw, height, stride, bpp):
    """Undo the per-row filters of decompressed scanlines -> (height,
    stride) uint8."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != height * (stride + 1):
        raise ValueError("PNG: image data has the wrong size")
    rows = rows.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:                                    # None
            recon = line.copy()
        elif kind == 1:                                  # Sub
            recon = line.reshape(-1, bpp).astype(np.uint64).cumsum(
                axis=0).astype(np.uint8).reshape(-1)
        elif kind == 2:                                  # Up
            recon = line + prior
        elif kind in (3, 4):                             # Average, Paeth
            recon = bytearray(stride)
            up = prior.tolist()
            filt = line.tolist()
            for i in range(stride):
                a = recon[i - bpp] if i >= bpp else 0
                if kind == 3:
                    pred = (a + up[i]) >> 1
                else:
                    pred = _paeth(a, up[i], up[i - bpp] if i >= bpp else 0)
                recon[i] = (filt[i] + pred) & 0xFF
            recon = np.frombuffer(bytes(recon), np.uint8)
        else:
            raise ValueError(f"PNG: unknown row filter {kind}")
        out[y] = recon
        prior = out[y]
    return out


def imread(path):
    """A PNG file as a numpy array: (H, W) uint8, (H, W, 3) or (H, W, 4)
    uint8, or (H, W) uint16."""
    with open(str(path), "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if (color, depth) not in _FORMATS or interlace != 0:
        raise ValueError(f"{path}: unsupported PNG (color type {color}, "
                         f"bit depth {depth}, interlace {interlace})")
    channels, dtype = _FORMATS[(color, depth)]
    bpp = channels * depth // 8
    pixels = _unfilter(zlib.decompress(b"".join(idat)), height, width * bpp,
                       bpp)
    image = pixels.view(dtype).astype(np.dtype(dtype).newbyteorder("="))
    return image.reshape((height, width, channels) if channels > 1
                         else (height, width))


def _chunk(kind, payload):
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def imsave(path, array):
    """Write (H, W) uint8, (H, W, 3) or (H, W, 4) uint8, or (H, W)
    uint16 as PNG."""
    array = np.asarray(array)
    if array.dtype == np.uint8 and array.ndim == 2:
        color, depth = 0, 8
    elif (array.dtype == np.uint8 and array.ndim == 3
          and array.shape[2] in (3, 4)):
        color, depth = (2 if array.shape[2] == 3 else 6), 8
    elif array.dtype == np.uint16 and array.ndim == 2:
        color, depth = 0, 16
        array = array.astype(">u2")
    else:
        raise ValueError(f"imsave: unsupported array {array.dtype} "
                         f"{array.shape}")
    height, width = array.shape[:2]
    rows = np.ascontiguousarray(array).view(np.uint8).reshape(height, -1)
    scanlines = np.concatenate(
        [np.zeros((height, 1), np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", width, height, depth, color, 0, 0, 0)
    with open(str(path), "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(scanlines.tobytes()))
                + _chunk(b"IEND", b""))


def rgb2gray(image):
    """ITU-R 601 luma on the host, matching skimage.color.rgb2gray on
    uint8/float; a 2-D image passes through as float32."""
    image = np.asarray(image)
    if image.ndim == 2:
        return image.astype(np.float32)
    if image.dtype == np.uint8:
        image = image.astype(np.float32) / 255.0
    rgb = image[..., :3].astype(np.float32)
    return rgb @ np.array([0.2125, 0.7154, 0.0721], dtype=np.float32)
