"""Device and dtype selection shared by every entry point of the port, and
the rule by which a process group carries a device's tensors."""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["float_dtype", "resolve_device", "group_backend", "staged_on_host", "via_host",
           "world_backend"]


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


def group_backend(group, device: torch.device) -> str:
    """The backend that carries ``device``'s tensors in ``group`` (``None``:
    the default group)."""
    try:
        name = str(dist.get_backend(group))
    except (RuntimeError, ValueError, KeyError):  # a backend outside the registry
        name = group.name()
    for part in name.lower().split(","):  # "cpu:gloo,cuda:nccl"
        dev, _, be = part.rpartition(":")
        if not dev or dev == device.type:
            return be
    raise ValueError(f"group backend {name!r} carries no {device.type} tensors")


def staged_on_host(device: torch.device, backend: str) -> bool:
    """Whether a ``backend`` group carries ``device``'s tensors through host
    memory: gloo takes a card's tensor for a collective or a point-to-point
    send only from the host (NCCL takes it as it is)."""
    return backend == "gloo" and device.type == "cuda"


def world_backend(device: torch.device, world: int) -> str:
    """The backend of a new group of ``world`` ranks on ``device``: NCCL
    where each rank has a card of its own, gloo otherwise (a card's tensors
    then staged through the host, :func:`staged_on_host`)."""
    if device.type == "cuda" and dist.is_nccl_available() and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def via_host(t: torch.Tensor, group=None) -> bool:
    """Whether ``group`` carries ``t`` through host memory."""
    return staged_on_host(t.device, group_backend(group, t.device))
