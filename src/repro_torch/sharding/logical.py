"""Logical-axis sharding on a ``torch.distributed`` device mesh (the port's
``repro/sharding/logical.py``).

Every parameter and activation of :mod:`repro_torch.models` is named by
*logical* axes ("vocab", "embed", "q_heads", "ff", "experts", "batch",
"seq", ...).  An :class:`AxisRules` table maps each logical name to mesh
axes with the reference's **divisibility-aware resolver**: the first
candidate mesh axis (or tuple of axes) that evenly divides the dimension
and uses no mesh axis another dimension of the same tensor already took
wins; otherwise the dimension is replicated.  So whisper-tiny's 6 heads,
grok-1's 8 experts and mamba2's 50,280 vocab replicate on a 16-way model
axis without a case of their own.

The mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with named
dims; the resolver reads only its dim names and sizes.  A resolved
:class:`P` (one entry per tensor dim: a mesh-axis name, a tuple of them,
or ``None``) becomes DTensor placements through :func:`placements`: a dim
that takes ``("pod", "data")`` is ``Shard(i)`` on both mesh dims, in that
order, which is JAX's row-major split of the composed axis.

The rules are held per thread, so model code stays mesh-agnostic:
``constrain(x, "batch", "seq", "embed_act")`` is a no-op outside a rules
context, at a world of one, or on a plain tensor, and inside one
redistributes a DTensor to the resolved placements (the reference's
``with_sharding_constraint``).
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Sequence

import torch

__all__ = [
    "AxisRules",
    "NamedSharding",
    "P",
    "constrain",
    "current_rules",
    "default_rules",
    "distribute_params",
    "gather_params",
    "is_distributed",
    "param_sharding",
    "placements",
    "resolve_spec",
    "split_heads",
    "use_rules",
]


class P(tuple):
    """A partition spec: per tensor dim a mesh-axis name, a tuple of mesh-axis
    names or ``None``.  A tuple, so it equals a tuple of the same entries, as
    the reference's ``PartitionSpec`` does."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclass(frozen=True)
class AxisRules:
    """Ordered logical->mesh candidates.  Each logical name maps to a list of
    candidates; a candidate is a mesh-axis name or a tuple of mesh-axis names
    (tried as a unit, e.g. ("pod", "data") for the composed DP group)."""

    rules: dict[str, tuple] = field(default_factory=dict)
    mesh: object | None = None  # a DeviceMesh with named dims

    def candidates(self, name: str) -> tuple:
        return self.rules.get(name, ())


def _mesh_axes(mesh) -> dict[str, int]:
    """The mesh's dim names and sizes, in order."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def default_rules(mesh, *, serving: bool = False) -> AxisRules:
    """The production rule table, the reference's:

    * data-parallel axes compose across pods;
    * tensor-parallel dims prefer "model";
    * FSDP shards the embed/ff-in dims of weights over "data" for training;
      ``serving=True`` drops FSDP (weights replicated across the dp axis,
      TP only), since a one-token decode step cannot amortize per-step
      weight all-gathers;
    * sequence-parallel candidates for long-context caches.
    """
    has_pod = "pod" in _mesh_axes(mesh)
    dp = ("pod", "data") if has_pod else ("data",)
    rules = {
        # activations
        "batch": (dp, "data"),
        "seq": (),  # replicated in training activations
        "seq_shard": (("data", "model"), "model", "data"),  # long-context SP
        "embed_act": (),  # activation d_model stays unsharded (TP on heads)
        # params: TP dims
        "vocab": ("model",),
        "q_heads": ("model",),
        "kv_heads": ("model",),
        "heads_merged": ("model",),  # fused head*dh dims
        "ff": ("model",),
        "experts": ("model",),
        "ssm_inner": ("model",),  # mamba d_inner / heads
        # params: FSDP dims (the non-TP dim of each matrix); dropped when
        # serving (see the docstring)
        "embed": () if serving else ("data",),
        "embed_kv": () if serving else ("data",),
        "conv_dim": (),
        # never sharded
        "unit": (),
        "pos_in_head": (),
        "dstate": (),
        "capacity": (),
    }
    return AxisRules(rules=rules, mesh=mesh)


_local = threading.local()


def current_rules() -> AxisRules | None:
    return getattr(_local, "rules", None)


@contextlib.contextmanager
def use_rules(rules: AxisRules):
    prev = current_rules()
    _local.rules = rules
    try:
        yield rules
    finally:
        _local.rules = prev


def resolve_spec(names: Sequence[str | None], shape: Sequence[int], rules: AxisRules) -> P:
    """Resolve logical names for each dim of ``shape`` to a :class:`P`.

    Divisibility-aware: a candidate is used only if it divides the dim and
    none of its mesh axes is already used by an earlier dim.
    """
    if rules.mesh is None:
        raise ValueError("resolve_spec needs rules with a mesh")
    axes = _mesh_axes(rules.mesh)
    used: set[str] = set()
    out = []
    for name, dim in zip(names, shape):
        placed = None
        if name is not None:
            for cand in rules.candidates(name):
                group = tuple(cand) if isinstance(cand, (tuple, list)) else (cand,)
                if any(a not in axes or a in used for a in group):
                    continue
                size = 1
                for a in group:
                    size *= axes[a]
                if dim % size:
                    continue
                placed = group if len(group) > 1 else group[0]
                used.update(group)
                break
        out.append(placed)
    return P(*out)


def placements(spec: Sequence, mesh) -> tuple:
    """DTensor placements on ``mesh`` of a resolved spec: ``Shard(i)`` on each
    mesh dim that dim ``i`` takes (a tuple of axes in its order), ``Replicate``
    on the others."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            out[names.index(a)] = Shard(i)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A resolved spec on a mesh: what ``distribute_tensor(t, s.mesh,
    s.placements)`` and :func:`repro_torch.training.checkpoint.restore`
    take."""

    mesh: object
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def is_distributed(x) -> bool:
    """Whether ``x`` is a DTensor (without importing DTensor for a plain
    tensor)."""
    if type(x) is torch.Tensor or not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _active(rules: AxisRules | None) -> bool:
    return rules is not None and rules.mesh is not None and rules.mesh.size() > 1


def constrain(x: torch.Tensor, *names: str | None) -> torch.Tensor:
    """Redistribute a DTensor ``x`` to its logical names' resolved placements
    if rules with a mesh of more than one rank are active; a no-op otherwise
    (and on a plain tensor)."""
    rules = current_rules()
    if not _active(rules):
        return x
    if not is_distributed(x):
        return x
    want = placements(resolve_spec(names, x.shape, rules), rules.mesh)
    if tuple(x.placements) == want:
        return x
    x = x.redistribute(rules.mesh, want)
    local = x.to_local()
    if local.is_contiguous():
        return x
    # a shard moved off an uneven dim (whisper's 1,500 frames over 16 ranks)
    # can come back as a view of its padded rows, which a later view refuses
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local.contiguous(), x.device_mesh, x.placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def param_sharding(spec_tree, params, rules: AxisRules):
    """A :class:`NamedSharding` for every weight of ``params`` (a
    :class:`repro_torch.models.common.Params`) from the model's logical spec
    tree (``api.specs()``, the reference's layout): the tree of
    ``params.tree`` (nested dicts, a list for a per-layer stack).  A layer of
    the reference's stacked ``unit/b<pos>`` (``enc``, ``dec``) takes that
    stack's names without the leading "unit"."""
    mesh = rules.mesh

    def one(names, p):
        return NamedSharding(mesh, resolve_spec(names, p.shape, rules))

    def walk(specs, module):
        out = {name: one(specs[name], p) for name, p in module._parameters.items()}
        for name, child in module._modules.items():
            if isinstance(child, torch.nn.ModuleList):
                if name == "layers":  # the LM's stack: layer i is unit/b<i % unit_size>
                    units = specs["unit"]
                    stacks = [units[f"b{i % len(units)}"] for i in range(len(child))]
                else:
                    stacks = [specs[name]] * len(child)
                out[name] = [walk(_unstacked(s), c) for s, c in zip(stacks, child)]
            else:
                out[name] = walk(specs[name], child)
        return out

    return walk(spec_tree, params)


def _unstacked(specs):
    """A stacked spec tree's names without their leading "unit"."""
    if isinstance(specs, dict):
        return {k: _unstacked(v) for k, v in specs.items()}
    if specs[:1] != ("unit",):
        raise ValueError(f"a stacked leaf's names start with 'unit': {specs}")
    return tuple(specs[1:])


def split_heads(x: torch.Tensor, heads: int, name: str) -> torch.Tensor:
    """``x`` [B, S, heads * dh] as [B, S, heads, dh].  A DTensor first takes
    the placements of ("batch", None, ``name``, None) at the split shape, so
    that its merged dim is split over the mesh only where the heads are."""
    B, S, merged = x.shape
    shape = (B, S, heads, merged // heads)
    rules = current_rules()
    if _active(rules) and is_distributed(x):
        want = placements(resolve_spec(("batch", None, name, None), shape, rules), rules.mesh)
        if tuple(x.placements) != want:
            x = x.redistribute(rules.mesh, want)
    return x.reshape(shape)


def _distribute(t: torch.Tensor, sharding: NamedSharding):
    """``t``, the same full value on every rank, as a DTensor: each rank keeps
    its own shard, with no collective."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, sharding.mesh, sharding.placements, src_data_rank=None)


def distribute_params(params, shardings):
    """Each weight of ``params`` (a ``Params`` holding the same full values on
    every rank) replaced in place by a DTensor on its :class:`NamedSharding`
    in ``shardings`` (:func:`param_sharding`'s tree), keeping its gradient
    flag; returns ``params``."""

    def walk(module, tree):
        for name, p in list(module._parameters.items()):
            module._parameters[name] = torch.nn.Parameter(
                _distribute(p.detach(), tree[name]), requires_grad=p.requires_grad)
        for name, child in module._modules.items():
            if isinstance(child, torch.nn.ModuleList):
                for c, t in zip(child, tree[name], strict=True):
                    walk(c, t)
            else:
                walk(child, tree[name])

    walk(params, shardings)
    return params


def gather_params(params):
    """A ``Params`` of the same names whose weights are the full values of
    ``params``' DTensors (a collective every rank of their mesh calls); a
    plain weight is kept as it is."""
    return params.map(lambda p: p.full_tensor() if is_distributed(p) else p)
