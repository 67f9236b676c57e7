"""Device and dtype selection shared by every entry point of the port."""

from __future__ import annotations

import torch

__all__ = ["float_dtype", "resolve_device"]


def float_dtype(x64: bool = True) -> torch.dtype:
    """The solve dtype: float64 (the reference's ``enable_x64``) or float32."""
    return torch.float64 if x64 else torch.float32


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``.  Nothing falls back to the CPU quietly: with
    no card present the caller has to ask for ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port "
            "on the CPU"
        )
    return dev
