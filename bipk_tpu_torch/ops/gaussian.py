"""Student-t draws by the polar method (port of ``bipk_tpu/ops/gaussian.py``
``student_t``), with the uniforms injected so a draw is a deterministic
function of its inputs — the CUDA kernels and the JAX package can then be
fed the same numbers."""

from __future__ import annotations

import math

import torch


def student_t(df: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Exact ``t_df`` draws from two uniforms ``u, v`` in ``[0, 1)``.

    ``t = sqrt(df (w^{-2/df} - 1)) cos(2 pi v)`` with ``w = 1 - u`` in
    ``(0, 1]``: the JAX package draws ``u`` with ``jax.random.uniform`` and
    takes ``1 - u`` (``w = 0`` would overflow ``w^{-2/df}``), and the CUDA
    kernels take the same raw ``u``. ``df`` broadcasts against ``u``.
    """
    w = 1.0 - u
    r = torch.sqrt(df * torch.expm1(-(2.0 / df) * torch.log(w)))
    return r * torch.cos((2.0 * math.pi) * v)
