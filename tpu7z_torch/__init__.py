"""PyTorch and CUDA port of tpu7z's device tier.

The LZ4 device block encoder runs through hand-written Hopper kernels
(`ops/lz4_cuda.py`, sources in `csrc/`), with a plain PyTorch version of
every stage (`ops/lz4_plane.py`) that the CPU path uses. The package
imports neither JAX nor tpu7z.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
