"""ctypes bindings for the native dataset prefetcher (counterpart of
``tadataka_tpu/dataset/native_loader.py``).

The library is built at first use from the checkout's
``native/png_decode.cpp`` and ``native/dataset_loader.cpp`` with ``g++``
and the flags of ``native/Makefile``, into
``build/tadataka_torch/native/`` (under a name that holds a hash of the
sources and flags); ``native/`` itself is never written.  Where there is
no toolchain, both readers decode through the port's own codec
(``dataset/image_io.imread``), as the JAX module falls back to PIL;
:func:`native_available` says which reader runs.
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from tadataka_torch.dataset.image_io import imread

_ROOT = Path(__file__).resolve().parents[2]
_NATIVE_DIR = _ROOT / "native"
_SOURCES = ("png_decode.cpp", "dataset_loader.cpp")
# native/Makefile's CXXFLAGS and LDFLAGS
_CXXFLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall")
_LDFLAGS = ("-shared", "-lz", "-lpthread")
BUILD_DIR = _ROOT / "build" / "tadataka_torch" / "native"
_lib = None
_failed = None


def _build():
    """Compile the library (if its hashed file is absent); its path."""
    sources = [_NATIVE_DIR / s for s in _SOURCES]
    digest = hashlib.sha256(b"".join(s.read_bytes() for s in sources)
                            + " ".join(_CXXFLAGS + _LDFLAGS).encode())
    out = BUILD_DIR / f"libtadataka_native_{digest.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.run(
            ["g++", *_CXXFLAGS, *map(str, sources), *_LDFLAGS, "-o", tmp],
            capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"g++ failed (exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(_build()))
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_create.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.loader_shape.restype = ctypes.c_int
    lib.loader_shape.argtypes = [ctypes.c_void_p, ctypes.c_long] + \
        [ctypes.POINTER(ctypes.c_int)] * 4
    lib.loader_copy.restype = ctypes.c_int
    lib.loader_copy.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                ctypes.POINTER(ctypes.c_uint8),
                                ctypes.c_long]
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    lib.decode_png_file.restype = ctypes.c_int
    lib.decode_png_file.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    _lib = lib
    return lib


def native_available():
    """True if the native library is built and loaded; False if it could
    not be (the readers then decode through ``image_io.imread``)."""
    global _failed
    if _lib is None and _failed is None:
        try:
            _load()
        except (OSError, RuntimeError) as error:
            _failed = error
    return _lib is not None


def _as_array(buf, w, h, ch, depth):
    dtype = np.uint16 if depth == 16 else np.uint8
    flat = np.frombuffer(buf, dtype=dtype)
    return flat.reshape(h, w, ch) if ch > 1 else flat.reshape(h, w)


def _dims():
    return [ctypes.c_int() for _ in range(4)]


def imread_native(path):
    """Decode one PNG through the native decoder (through
    ``image_io.imread`` where it is not available)."""
    if not native_available():
        return imread(path)
    lib = _lib
    w, h, ch, depth = dims = _dims()
    refs = [ctypes.byref(d) for d in dims]
    rc = lib.decode_png_file(str(path).encode(), None, 0, *refs)
    if rc != 0:
        raise IOError(f"png probe failed ({rc}) for {path}")
    nbytes = w.value * h.value * ch.value * (depth.value // 8)
    buf = (ctypes.c_uint8 * nbytes)()
    rc = lib.decode_png_file(str(path).encode(), buf, nbytes, *refs)
    if rc != 0:
        raise IOError(f"png decode failed ({rc}) for {path}")
    return _as_array(buf, w.value, h.value, ch.value, depth.value).copy()


class PrefetchingLoader:
    """Ordered decode-ahead iteration over a list of PNG paths.

    Native workers decode up to ``capacity`` frames ahead;
    ``__getitem__`` must be consumed in order (the prefetch window
    advances with consumption).  Without the native library each frame
    is decoded when it is asked for.
    """

    def __init__(self, paths, n_threads=2, capacity=8):
        self.paths = [str(p) for p in paths]
        self._handle = None
        self._lib = _lib if native_available() else None
        if self._lib is not None:
            arr = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths])
            self._handle = self._lib.loader_create(arr, len(self.paths),
                                                   n_threads, capacity)
        self._next = 0

    def __len__(self):
        return len(self.paths)

    def __iter__(self):
        for i in range(len(self.paths)):
            yield self[i]

    def __getitem__(self, index):
        if index != self._next:
            raise IndexError(
                f"PrefetchingLoader is in-order: expected {self._next}, "
                f"got {index}")
        if self._lib is None:
            self._next = index + 1
            return imread(self.paths[index])
        w, h, ch, depth = dims = _dims()
        rc = self._lib.loader_shape(self._handle, index,
                                    *[ctypes.byref(d) for d in dims])
        if rc != 0:
            raise IOError(f"decode failed ({rc}) for {self.paths[index]}")
        nbytes = w.value * h.value * ch.value * (depth.value // 8)
        buf = (ctypes.c_uint8 * nbytes)()
        rc = self._lib.loader_copy(self._handle, index, buf, nbytes)
        if rc != 0:
            raise IOError(f"copy failed ({rc})")
        self._next = index + 1
        return _as_array(buf, w.value, h.value, ch.value,
                         depth.value).copy()

    def close(self):
        if self._handle:
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
