"""PyTorch / CUDA port of the redundant-assignment clustering system.

The JAX package ``repro`` is the reference; this package mirrors its layout
so that each module has one counterpart there.  Plain tensor code is
PyTorch; each TPU kernel on a ported path is a hand-written Hopper kernel
under ``csrc/`` (see :mod:`repro_torch.kernels`).
"""

from .device import resolve_device  # noqa: F401
