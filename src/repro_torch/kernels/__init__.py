"""Hand-written CUDA kernels of the port, one package per reference kernel
family, each with ``ref.py`` (plain PyTorch), ``kernel.py`` (ctypes wrapper
of ``csrc/*.cu``) and ``ops.py`` (dispatch on the tensor's device)."""

from __future__ import annotations

from repro_torch.kernels.pdhg_update import kernel as _pdhg_kernel
from repro_torch.kernels.tree_matvec import kernel as _tree_kernel

__all__ = ["launch_counts", "reset_launch_counts"]

_TABLES = (_tree_kernel.LAUNCHES, _pdhg_kernel.LAUNCHES)


def launch_counts() -> dict[str, int]:
    """Launches of every kernel wrapper since the last reset."""
    return {name: count for table in _TABLES for name, count in table.items()}


def reset_launch_counts() -> None:
    for table in _TABLES:
        for name in table:
            table[name] = 0
