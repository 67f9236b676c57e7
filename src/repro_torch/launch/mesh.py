"""Production and test meshes (the port's ``repro/launch/mesh.py``).

Functions, not module-level constants: importing this module touches no
process group.  Each builds a :class:`torch.distributed.device_mesh.DeviceMesh`
with named dims over the current default process group, whose world size
must be the mesh's size (a ``"fake"`` group of 256 or 512 ranks is enough to
lay the production meshes out without a card).
"""

from __future__ import annotations

from repro_torch.compat import resolve_device

__all__ = ["make_production_mesh", "make_test_mesh"]


def _mesh(shape: tuple, names: tuple, device):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(resolve_device(device).type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16 x 16 = 256 ranks ("data", "model") per pod; 2 pods = 512 ranks
    ("pod", "data", "model") multi-pod.  ``device``: ``None`` means ``cuda``."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"), device)
    return _mesh((16, 16), ("data", "model"), device)


def make_test_mesh(data: int = 1, model: int = 1, *, device=None):
    """A ("data", "model") mesh of ``data * model`` ranks over the current
    process group.  ``device``: ``None`` means ``cuda``."""
    return _mesh((data, model), ("data", "model"), device)
