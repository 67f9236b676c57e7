from repro_torch.configs.base import SHAPES, ArchConfig, ShapeSpec
from repro_torch.configs.registry import ARCHS, get_arch, list_archs

__all__ = [
    "SHAPES",
    "ARCHS",
    "ArchConfig",
    "ShapeSpec",
    "get_arch",
    "list_archs",
]
