"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``torch.device(device)``; raise if CUDA is asked for but absent.

    Entry points default to ``"cuda"`` and never fall back to the CPU on
    their own: a caller that wants the CPU (the tests) says so. Also pins
    float32 products to full precision: the weighted moments are f32
    matrix-vector products, and TF32 would keep only ~3 decimal digits.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device
