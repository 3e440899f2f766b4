"""PyTorch/CUDA port of ``bipk_tpu`` for one NVIDIA H100.

The JAX package ``bipk_tpu`` is the reference; this package mirrors its
layout (``ops/``, ``models/``, ``algorithms/``, ``parallel/``) and names so
each function has a findable counterpart. It imports ``torch`` and numpy
only — never ``jax`` and nothing of ``bipk_tpu``.

The hot per-particle operations run as hand-written CUDA kernels
(``bipk_tpu_torch/csrc/*.cu``, bound in :mod:`bipk_tpu_torch.ops.cuda_kernels`);
each has a plain PyTorch version beside it that the CPU tests use.
"""

from bipk_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
