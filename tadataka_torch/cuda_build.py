"""Build a CUDA C++ source of the package into a shared library and load
it with ``ctypes``.

Each ``csrc/*.cu`` exposes plain ``extern "C"`` launch functions, so it
compiles with ``nvcc`` alone in seconds (no PyTorch headers).  The
library is built at first use into ``build/tadataka_torch/`` at the root
of the checkout, under a name that holds a hash of the source and the
flags, so a changed source rebuilds.  A failed build raises with nvcc's
output.  Nothing is downloaded and nothing outside the checkout is
compiled.
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

from tadataka_torch.utils.timing import count, span

BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "tadataka_torch"

# --fmad=false and no fast math: every product and sum is rounded as in
# the plain PyTorch version, so a kernel can match it bit for bit
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v",
              "-shared", "-Xcompiler", "-fPIC")


class BuiltLibrary:
    """A loaded kernel library with its build time and ptxas report."""

    def __init__(self, lib, path, seconds, log):
        self.lib = lib
        self.path = path
        self.seconds = seconds   # 0.0 when the library was already built
        self.log = log           # nvcc/ptxas output of this build ('' if cached)


def _nvcc():
    """nvcc of the toolkit PyTorch finds ($CUDA_HOME, $CUDA_PATH, the
    nvcc on $PATH, or /usr/local/cuda)."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None or not (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build(source: Path, defines=()) -> BuiltLibrary:
    """Compile ``source`` (if its hashed library is absent) and load it;
    ``defines``: (name, value) pairs passed to nvcc as -Dname=value.
    Marked as the span "cuda_build.<stem>", a compile counted as
    "cuda_build.compile"."""
    source = Path(source)
    with span("cuda_build." + source.stem):
        return _build(source, defines)


def _build(source, defines):
    flags = NVCC_FLAGS + tuple(f"-D{name}={value}" for name, value in defines)
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{source.stem}_{digest}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        count("cuda_build.compile")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *flags, "-o", tmp, str(source)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed on {source.name} (exit {proc.returncode}):\n"
                f"{log}")
        os.replace(tmp, out)     # atomic: no reader sees a partial file
    return BuiltLibrary(ctypes.CDLL(str(out)), out, seconds, log)
