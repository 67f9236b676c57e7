"""Collectives of a card's tensors staged through host memory over gloo.

NCCL cannot put two ranks on one card, so a mesh of several ranks on one
H100 runs over gloo, and gloo takes a card's tensors only from the host
(``compat.staged_on_host``; handed CUDA tensors, its collectives crashed the
ranks on the H100).  DTensor issues its collectives itself, through the
functional collectives (``torch.ops._c10d_functional``: all-gathers,
reduce-scatters, all-reduces, all-to-alls) and DTensor's own shard-to-shard
all-to-all (with ``src_data_rank=None``, as the port distributes tensors,
it broadcasts and scatters nothing).  :func:`install` gives each of these ops a
kernel for CUDA tensors that, where the group carries them through the host
(``compat.via_host``), copies the input to the host, runs the same
collective there on the gloo group, waits for it and copies the result back
to the input's device (the all-to-all as an all-gather and a chunk, as
DTensor does on the CPU); on any other group (NCCL) it runs the op's own
kernel.  The step, the parameters and the kernels stay on the card; a CPU
tensor takes the ops' own path.

Every staged call is counted in :data:`COLLECTIVES` by kind: the calls,
and the bytes each rank sends in (its own input, whatever the algorithm
moves on the wire).
"""

from __future__ import annotations

import torch

from repro_torch.compat import via_host

__all__ = ["COLLECTIVES", "collective_counts", "install", "kernel", "staged"]

COLLECTIVES: dict[str, list[int]] = {}  # kind -> [calls, bytes sent in]
_LIBS: list = []  # the registrations, kept alive


def collective_counts() -> dict[str, dict[str, int]]:
    """:data:`COLLECTIVES` as ``{kind: {"calls": n, "bytes": b}}``."""
    return {k: {"calls": c, "bytes": b} for k, (c, b) in sorted(COLLECTIVES.items())}


def _count(kind: str, tensors) -> None:
    entry = COLLECTIVES.setdefault(kind, [0, 0])
    entry[0] += 1
    entry[1] += sum(t.numel() * t.element_size() for t in tensors)


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu").contiguous()


def _wait(t: torch.Tensor) -> torch.Tensor:
    return torch.ops._c10d_functional.wait_tensor(t)


def _group(group_name):
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(group_name) if isinstance(group_name, str) else group_name


def _staged_op(op, kind):
    """The staged kernel of the out-of-place functional collective ``op``
    (called on host tensors it takes its own gloo path), counted as
    ``kind``."""
    def kernel(input, *args):
        _count(kind, [input])
        return _wait(op(_host(input), *args)).to(input.device)
    return kernel


def _shard_dim_alltoall(input, gather_dim, shard_dim, group_name):
    """DTensor's Shard(gather_dim) -> Shard(shard_dim) on one mesh dim: the
    group's shards gathered on ``gather_dim``, this rank's chunk of
    ``shard_dim`` kept (``torch.chunk``'s split, DTensor's)."""
    import torch.distributed._functional_collectives as funcol

    _count("all_to_all", [input])
    group = _group(group_name)
    gather = getattr(funcol, "all_gather_single", None) or funcol.all_gather_tensor
    full = gather(_host(input), gather_dim, group)
    full = full.wait() if isinstance(full, funcol.AsyncCollectiveTensor) else full
    parts = list(torch.chunk(full, group.size(), dim=shard_dim))
    parts += [full.narrow(shard_dim, 0, 0)] * (group.size() - len(parts))  # DTensor's empties
    return parts[group.rank()].contiguous().to(input.device)


# the functional collectives DTensor issues, by the kind each is counted as
_KINDS = {
    "all_reduce": "all_reduce",
    "all_gather_into_tensor": "all_gather",
    "reduce_scatter_tensor": "reduce_scatter",
    "all_to_all_single": "all_to_all",
}


def staged(name: str):
    """The staged kernel of ``_c10d_functional::<name>`` (of
    ``_dtensor::shard_dim_alltoall`` for ``"shard_dim_alltoall"``), callable
    on tensors of any device."""
    if name == "shard_dim_alltoall":
        return _shard_dim_alltoall
    import torch.distributed._functional_collectives  # noqa: F401  (registers the ops)

    return _staged_op(getattr(torch.ops._c10d_functional, name).default, _KINDS[name])


def _op(name: str):
    import torch.distributed._functional_collectives  # noqa: F401  (registers the ops)
    import torch.distributed.tensor._collective_utils  # noqa: F401  (registers _dtensor's)

    if name == "shard_dim_alltoall":
        return torch.ops._dtensor.shard_dim_alltoall.default
    return getattr(torch.ops._c10d_functional, name).default


def kernel(name: str):
    """The kernel :func:`install` registers for ``name`` (as :func:`staged`
    names it): :func:`staged` where the group (the last argument) carries
    the input through the host, else the op's own kernel (the composite
    one, which the CPU key holds and which runs on any device)."""
    op, stage = _op(name), staged(name)

    def run(input, *args):
        if via_host(input, _group(args[-1])):
            return stage(input, *args)
        return op.redispatch(torch._C.DispatchKeySet(torch._C.DispatchKey.CPU), input, *args)
    return run


def install() -> None:
    """Register the staged kernels for CUDA tensors (once per process; a
    run whose group carries a card's tensors through the host calls it)."""
    if _LIBS:
        return
    kernels = {name: kernel(name) for name in (*_KINDS, "shard_dim_alltoall")}
    lib = torch.library.Library("_c10d_functional", "IMPL")
    for name in _KINDS:
        lib.impl(name, kernels[name], "CUDA")
    dt = torch.library.Library("_dtensor", "IMPL")
    dt.impl("shard_dim_alltoall", kernels["shard_dim_alltoall"], "CUDA")
    _LIBS.extend([lib, dt])
