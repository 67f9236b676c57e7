"""FLOP and byte accounting of a traced call (the port's
``repro/analysis/flops.py``).

The reference walks a compiled HLO module.  The port has none: the program
it walks is the stream of ATen ops and custom ops one call dispatches, seen
by :class:`CostCounter`, a ``TorchDispatchMode``, on ``meta`` tensors (the
dry run: shapes only, nothing computed) or on a device's real ones.  Eager
PyTorch launches one kernel an op, so each op is what a fusion is to the
reference.  The reference's rules:

* a matrix product (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ...) costs
  2 * |result| * |contracted dims| FLOPs, kept under ``by_op["dot"]``; a
  convolution 2 * |result| * (C_in / groups) * |window| (its backward that
  for each gradient it returns);
* the flash-attention custom ops (``repro_torch::flash_attention`` and its
  ``_lse`` variant, :mod:`repro_torch.kernels.flash_attention.ops`) cost
  4 * B * H * dh per visible (query, key) pair, the kernel's count
  (``PERF.md`` row 10: under a causal mask the triangle, about half of
  Sq * Sk), kept under ``by_op["flash_attention"]``.  This is the count of
  the kernel's path, on a card and on ``meta`` tensors; on the CPU the op's
  plain version computes every pair (``attention_ref``, the full S^2
  logits), which the counter does not see inside the op;
* an elementwise op costs 1 FLOP an output element, a reduction 1 an input
  element;
* views, copies, conversions, fills and collectives cost no FLOPs.

Bytes (``hbm_bytes``) are each launched op's operands and results, each
tensor's elements once (a broadcast dim, stride 0, once); a view moves
none, and a collective's are its own record
(:mod:`repro_torch.analysis.hlo`).  ``peak_bytes`` is the largest total of
the storages created during the call that were alive at once (each counted
from its first op until it is freed): the call's live intermediates.
An op on DTensors is not counted itself: the counter hands it to DTensor,
which issues the rank's local ops and collectives, and those are.  The ops
DTensor's sharding propagation runs on stand-in tensors to infer an
output's shape are not the rank's program and are not counted.  A counter
given a ``device`` counts only the ops that touch a tensor on that device
type: a step's program on a card (or on ``meta``), not the host's own
tensor work beside it (a learning-rate schedule's 0-d scalars, DTensor's
shard-offset bookkeeping on CPU index tensors).
"""

from __future__ import annotations

import math
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.analysis import hlo
from repro_torch.kernels.flash_attention.ops import flops as flash_flops

__all__ = ["CostCounter", "OpCost", "analyze"]

_DOTS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "dot", "vdot", "mv", "addmv", "_scaled_mm"}
_CONVS = {"convolution", "_convolution", "convolution_backward"}
_FLASH = {"flash_attention", "flash_attention_lse"}
_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "argmax", "argmin", "logsumexp",
    "norm", "linalg_vector_norm", "var", "std", "var_mean", "std_mean", "any", "all",
    "_softmax", "_log_softmax", "cumsum", "cumprod", "nll_loss_forward", "nll_loss2d_forward",
    "topk", "sort",
}
# launched ops that only move, convert or fill data: bytes, no FLOPs
_MOVES = {
    "_to_copy", "clone", "copy_", "copy", "cat", "stack", "index", "index_select", "gather",
    "scatter", "scatter_", "scatter_add", "scatter_add_", "index_put", "index_put_", "index_add",
    "index_add_", "index_copy", "index_copy_", "embedding", "embedding_dense_backward",
    "repeat_interleave", "repeat", "constant_pad_nd", "flip", "roll", "slice_backward",
    "select_backward", "slice_scatter", "select_scatter", "as_strided_scatter", "zeros",
    "ones", "full", "fill_", "fill", "zero_", "zeros_like", "ones_like", "full_like",
    "new_zeros", "new_ones", "new_full", "arange", "tril", "triu", "masked_select",
    "nonzero", "masked_scatter", "randn", "rand", "randint", "normal_", "uniform_",
}
# ops that launch nothing
_NOTHING = {
    "empty", "empty_like", "new_empty", "empty_strided", "new_empty_strided", "_unsafe_view",
    "detach", "alias", "lift_fresh", "_local_scalar_dense", "wait_tensor",
    "_wrap_tensor_autograd", "set_", "resize_", "_has_compatible_shallow_copy_type",
    "is_same_size", "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
}


def _tensor_bytes(t: torch.Tensor) -> int:
    """The bytes a launch touches of ``t``: its elements, a broadcast dim
    (stride 0) once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size() if t.numel() else 0


def _is_dtensor(types) -> bool:
    if not types:
        return False
    from torch.distributed.tensor import DTensor

    return DTensor in types


def _tensors(x) -> list:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _dot_flops(name: str, args, out) -> float:
    if name in ("mm", "addmm", "_scaled_mm"):
        a = args[1] if name == "addmm" else args[0]
        return 2.0 * out.numel() * a.shape[-1]
    if name in ("bmm", "baddbmm", "addbmm"):
        a = args[0] if name == "bmm" else args[1]
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * (args[1] if name == "bmm"
                                                             else args[2]).shape[-1]
    if name in ("dot", "vdot"):
        return 2.0 * args[0].numel()
    a = args[1] if name == "addmv" else args[0]  # mv: [M, K] @ [K]
    return 2.0 * a.shape[0] * a.shape[1]


def _conv_flops(name: str, args, out) -> float:
    if name == "convolution_backward":
        grad_out, weight, mask = args[0], args[2], args[-1]
        per = 2.0 * grad_out.numel() * math.prod(weight.shape[1:])
        return per * (int(mask[0]) + int(mask[1]))
    weight = args[1]
    return 2.0 * out.numel() * math.prod(weight.shape[1:])


@dataclass
class OpCost:
    """What one traced call costs: ``flops``, ``hbm_bytes`` and ``by_op``
    (FLOPs by op kind) as the reference's ``HloCost``; ``calls`` the op
    instances by kind (``flash_attention`` and ``flash_attention_lse``: the
    kernel's launches on a card), ``collectives`` the collective records,
    ``peak_bytes`` the largest total of live intermediates, ``devices``
    the device types of the counted ops' results of one or more dims."""

    flops: float
    hbm_bytes: float
    by_op: dict
    calls: dict
    collectives: list = field(default_factory=list)
    peak_bytes: int = 0
    devices: tuple = ()


class CostCounter(TorchDispatchMode):
    """Counts the ops dispatched while it is entered (see the module's doc);
    :meth:`cost` gives the totals so far."""

    def __init__(self, device: str | None = None):
        super().__init__()
        self.device = device  # count only the ops touching this device type (None: all)
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.by_op: dict[str, float] = {}
        self.calls: dict[str, int] = {}
        self.collectives: list[dict] = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self.devices: set[str] = set()
        self._storages: set[int] = set()
        self._inferring = 0  # > 0 inside DTensor's shape inference
        self._unpatch = None

    def __enter__(self):
        self._unpatch = self._skip_shape_inference()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._unpatch()

    def _skip_shape_inference(self):
        """Wrap DTensor's shape inference (``ShardingPropagator.
        _propagate_tensor_meta_non_cached``, which runs the op on stand-in
        tensors) so that its ops go uncounted; returns the undo."""
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        real = ShardingPropagator._propagate_tensor_meta_non_cached

        def inferring(prop, *args, **kwargs):
            self._inferring += 1
            try:
                return real(prop, *args, **kwargs)
            finally:
                self._inferring -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = inferring

        def undo():
            ShardingPropagator._propagate_tensor_meta_non_cached = real

        return undo

    def cost(self) -> OpCost:
        return OpCost(self.flops, self.hbm_bytes, dict(self.by_op), dict(self.calls),
                      list(self.collectives), self.peak_bytes, tuple(sorted(self.devices)))

    def _add(self, kind: str, flops: float) -> None:
        self.flops += flops
        self.by_op[kind] = self.by_op.get(kind, 0.0) + flops

    def _freed(self, key: int, nbytes: int) -> None:
        self._storages.discard(key)
        self.live_bytes -= nbytes

    def _track(self, outs: list, ins: list) -> None:
        """Count each output storage created by this op as live until it is
        freed; an output that aliases an input (a view, an in-place op)
        adds nothing."""
        seen = {t.untyped_storage()._cdata for t in ins if t.layout == torch.strided}
        for t in outs:
            if t.layout != torch.strided:
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._storages:
                continue
            seen.add(key)
            self._storages.add(key)
            nbytes = st.nbytes()
            self.live_bytes += nbytes
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._freed, key, nbytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _is_dtensor(types):
            return NotImplemented  # DTensor runs it: its local ops come through here
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if types or self._inferring:
            return out  # another subclass, or DTensor's shape inference
        name = func.overloadpacket.__name__
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if self.device is not None and all(t.device.type != self.device for t in ins + outs):
            return out
        self.devices.update(t.device.type for t in outs if t.dim())
        kind = hlo.collective_kind(func)
        if kind is not None:
            self.calls[name] = self.calls.get(name, 0) + 1
            self.collectives.append({
                "kind": kind, "op": name, "shape": " ".join(hlo.shape_literal(t) for t in outs),
                "bytes": sum(t.numel() * t.element_size() for t in outs)})
            self._track(outs, ins)
            return out
        if name in _NOTHING or func.is_view:
            return out
        self.calls[name] = self.calls.get(name, 0) + 1
        self.hbm_bytes += sum(_tensor_bytes(t) for t in ins) + sum(_tensor_bytes(t) for t in outs)
        if func.namespace == "repro_torch" and name in _FLASH:
            q, k, _ = args[:3]
            self._add("flash_attention", flash_flops(q.shape, k.shape, bool(args[3])))
        elif name in _DOTS:
            self._add("dot", _dot_flops(name, args, outs[0]))
            if name in ("addmm", "baddbmm", "addbmm", "addmv"):
                self._add("add", float(outs[0].numel()))
        elif name in _CONVS:
            self._add("convolution", _conv_flops(name, args, outs[0] if outs else None))
        elif name in _REDUCTIONS:
            self._add(name, float(ins[0].numel()) if ins else 0.0)
        elif name not in _MOVES and outs:
            self._add(name, float(outs[0].numel()))
        self._track(outs, ins)
        return out


def analyze(fn, *args, device: str | None = None, **kwargs):
    """``(fn(*args, **kwargs), its OpCost)``, traced by a
    :class:`CostCounter` of ``device``."""
    with CostCounter(device) as counter:
        result = fn(*args, **kwargs)
    return result, counter.cost()
