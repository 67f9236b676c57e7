"""The lane axis of the K-scenario path.

Every solver, phase and kernel function takes ``[..., n]`` tensors: a
``[n]`` tensor is one scenario, a ``[K, n]`` tensor is K lanes solved
together, each lane its own problem over the shared topology.  A per-lane
scalar (a step size, a residual, ``t``) is a 0-d tensor for one scenario
and a ``[K, 1]`` lane column for K lanes, so it broadcasts against the
lanes' vectors as the 0-d tensor does against one vector.

The reductions below keep the one-scenario path's own calls
(``torch.max``, ``torch.sum``, ...) for a 1-D tensor and reduce the last
axis into a lane column for K lanes.  On the CPU each lane's row gives the
bits of the 1-D call.  On a card torch sums and scans the rows of a
``[K, n]`` tensor in an order that changes with K, so :func:`lane_sum` and
:func:`lane_cumsum` there take each lane's row alone, the ``[1, n]`` call a
one-lane solve makes: a lane's result is then that of its one-lane solve
whatever K (the allocator's own kernels add each lane in one order too).
The maxima, minima and masks are exact in any order.

Host decisions a single scenario takes with ``if`` are numpy bool arrays
of K entries for lanes; :func:`column` turns one into a lane column mask.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "column",
    "lane_cumsum",
    "lane_all",
    "lane_any",
    "lane_max",
    "lane_min",
    "lane_sum",
    "lane_scalar",
    "select",
]


def lane_max(v: torch.Tensor) -> torch.Tensor:
    return torch.max(v) if v.ndim == 1 else v.amax(-1, keepdim=True)


def lane_min(v: torch.Tensor) -> torch.Tensor:
    return torch.min(v) if v.ndim == 1 else v.amin(-1, keepdim=True)


def _by_lane(fn, v: torch.Tensor) -> torch.Tensor:
    """``fn`` over the last axis of ``v``: one call on the CPU, for a vector
    or for one lane; on a card for K > 1 lanes one call per lane's ``[1, n]``
    row, concatenated."""
    if v.ndim == 1 or v.shape[0] == 1 or v.device.type == "cpu":
        return fn(v)
    return torch.cat([fn(v[j : j + 1]) for j in range(v.shape[0])])


def lane_sum(v: torch.Tensor) -> torch.Tensor:
    if v.ndim == 1:
        return torch.sum(v)
    return _by_lane(lambda r: r.sum(-1, keepdim=True), v)


def lane_cumsum(v: torch.Tensor) -> torch.Tensor:
    """``torch.cumsum`` over the last axis (the plain tree sums' prefix)."""
    return _by_lane(lambda r: torch.cumsum(r, -1), v)


def lane_any(v: torch.Tensor) -> torch.Tensor:
    return torch.any(v) if v.ndim == 1 else v.any(-1, keepdim=True)


def lane_all(v: torch.Tensor) -> torch.Tensor:
    return torch.all(v) if v.ndim == 1 else v.all(-1, keepdim=True)


def lane_scalar(like: torch.Tensor, value: float) -> torch.Tensor:
    """``value`` as a 0-d tensor for one scenario, a lane column for K
    lanes, in ``like``'s dtype and device."""
    shape = () if like.ndim == 1 else like.shape[:-1] + (1,)
    return torch.full(shape, value, dtype=like.dtype, device=like.device)


def column(mask: np.ndarray, device) -> torch.Tensor:
    """A host bool array of K lanes as a ``[K, 1]`` mask on ``device``."""
    return torch.as_tensor(np.asarray(mask, bool), device=device).reshape(-1, 1)


def select(mask: np.ndarray, new, old):
    """Lane by lane ``new`` where ``mask`` else ``old``, through nested
    tuples of tensors (lane tensors ``[K, ...]``) and numpy arrays of K
    entries; ``None`` leaves stay ``None``."""
    mask = np.asarray(mask, bool)
    if isinstance(new, tuple):
        out = [select(mask, a, b) for a, b in zip(new, old)]
        return type(new)(*out) if hasattr(new, "_fields") else tuple(out)
    if new is None:
        return None
    if isinstance(new, torch.Tensor):
        col = column(mask, new.device).reshape((-1,) + (1,) * (new.ndim - 1))
        return torch.where(col, new, old)
    return np.where(mask, new, old)
