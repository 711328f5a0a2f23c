"""tadataka_torch — the PyTorch/CUDA port of ``tadataka_tpu``.

A second package beside the JAX one, written for one NVIDIA H100 (sm_90a).
It mirrors the JAX package's module tree and names, keeps its semantics
and drops its TPU workarounds: where the JAX code keeps a plain gather or
scatter form beside a TPU fast form, the port implements the plain form.
Every Pallas kernel on a ported path becomes a hand-written CUDA kernel
(built with ``nvcc`` at first use, see ``tadataka_torch/cuda_build.py``);
on a CPU tensor each kernel's wrapper runs its plain PyTorch version.

The port imports ``torch``, ``numpy`` and ``scipy`` (the TUM pose
files' quaternions, bundle adjustment's rotation vectors) only, and
``matplotlib`` inside ``viz``'s functions; it never imports ``jax`` or
``tadataka_tpu``, and it reads and writes PNG with its own codec (or
the C++ decoder of ``native/``, ``dataset/native_loader.py``).  Float32 matrix products
stay in full float32 (TF32 off, PyTorch's default) and no convolution is
used.
"""

__version__ = "0.1.0"

from tadataka_torch import flags  # noqa: F401
