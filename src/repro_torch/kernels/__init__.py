"""Hand-written CUDA kernels of the port, one package per reference kernel
family (the allocator's ``tree_matvec`` and ``pdhg_update``, the data plane's
``flash_attention``), each with ``ref.py`` (plain PyTorch), ``kernel.py`` (ctypes wrapper
of ``csrc/*.cu``) and ``ops.py`` (dispatch on the tensor's device)."""

from __future__ import annotations

from repro_torch.kernels.flash_attention import kernel as _flash_kernel
from repro_torch.kernels.pdhg_update import kernel as _pdhg_kernel
from repro_torch.kernels.tree_matvec import kernel as _tree_kernel

__all__ = ["lane_launch_counts", "launch_counts", "reset_launch_counts"]

_TABLES = (_tree_kernel.LAUNCHES, _pdhg_kernel.LAUNCHES, _flash_kernel.LAUNCHES)
# the allocator's launches that took [K, size] lanes (the K-scenario path)
_LANE_TABLES = (_tree_kernel.LANE_LAUNCHES, _pdhg_kernel.LANE_LAUNCHES)


def launch_counts() -> dict[str, int]:
    """Launches of every kernel wrapper since the last reset."""
    return {name: count for table in _TABLES for name, count in table.items()}


def lane_launch_counts() -> dict[str, int]:
    """Of those, the allocator kernels' launches over K lanes."""
    return {name: count for table in _LANE_TABLES for name, count in table.items()}


def reset_launch_counts() -> None:
    for table in _TABLES + _LANE_TABLES:
        for name in table:
            table[name] = 0
