"""The collective inventory of a traced step (the port's
``repro/analysis/hlo.py``).

The reference scans a compiled SPMD module's text for all-gather /
all-reduce / reduce-scatter / all-to-all / collective-permute ops.  The
port has no module: :class:`repro_torch.analysis.flops.CostCounter` records
every collective one rank issues while it traces a call (what DTensor and
``torch.distributed``'s functional collectives dispatch: the
``_c10d_functional`` ops, DTensor's ``shard_dim_alltoall`` and the
``c10d`` process-group ops) as a record ``{"kind", "op", "shape",
"bytes"}``, ``kind`` one of the reference's names and ``shape`` a typed
literal such as ``"bf16[8,128]"``.  :func:`collective_stats` sums them per
kind; it also reads HLO text in the reference's form, the reference's
rules and all.  Bytes are result bytes per op instance, as the reference
counts them: one rank's traffic.
"""

from __future__ import annotations

import re
from collections import defaultdict

import torch

__all__ = ["KINDS", "collective_kind", "collective_stats", "count_ops", "records_from_text",
           "shape_bytes", "shape_literal"]

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}
_TORCH_DTYPES = {
    torch.float64: "f64", torch.float32: "f32", torch.float16: "f16", torch.bfloat16: "bf16",
    torch.float8_e4m3fn: "f8e4m3fn", torch.float8_e5m2: "f8e5m2", torch.int64: "s64",
    torch.uint64: "u64", torch.int32: "s32", torch.uint32: "u32", torch.int16: "s16",
    torch.uint16: "u16", torch.int8: "s8", torch.uint8: "u8", torch.bool: "pred",
    torch.complex64: "c64", torch.complex128: "c128",
}

_SHAPE_RE = re.compile(r"\b([a-z0-9]+)\[([0-9,]*)\]")

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")

# the ops a traced rank issues, by (namespace, op name), and their kind
_OP_KINDS = {
    **{("_c10d_functional", op): "all-reduce"
       for op in ("all_reduce", "all_reduce_", "all_reduce_coalesced", "all_reduce_coalesced_")},
    **{("_c10d_functional", op): "all-gather"
       for op in ("all_gather_into_tensor", "all_gather_into_tensor_out",
                  "all_gather_into_tensor_coalesced")},
    **{("_c10d_functional", op): "reduce-scatter"
       for op in ("reduce_scatter_tensor", "reduce_scatter_tensor_coalesced")},
    ("_c10d_functional", "all_to_all_single"): "all-to-all",
    ("_dtensor", "shard_dim_alltoall"): "all-to-all",
    ("c10d", "allreduce_"): "all-reduce",
    ("c10d", "allgather_"): "all-gather",
    ("c10d", "_allgather_base_"): "all-gather",
    ("c10d", "reduce_scatter_"): "reduce-scatter",
    ("c10d", "_reduce_scatter_base_"): "reduce-scatter",
    ("c10d", "alltoall_"): "all-to-all",
    ("c10d", "alltoall_base_"): "all-to-all",
    ("c10d", "send"): "collective-permute",
    ("c10d", "recv_"): "collective-permute",
}

# op lines look like:  %name = bf16[8,128]{1,0} all-reduce(...), replica_groups=...
_OP_RE = re.compile(
    r"=\s*(?:\([^)]*\)|tuple\([^)]*\)|[a-z0-9]+\[[0-9,]*\][^ ]*)\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\("
)


def shape_bytes(text: str) -> int:
    """Total bytes of every typed shape literal in ``text``."""
    total = 0
    for dtype, dims in _SHAPE_RE.findall(text):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def shape_literal(t: torch.Tensor) -> str:
    """A tensor's typed shape in the reference's form, ``"f32[16,1024]"``."""
    return f"{_TORCH_DTYPES[t.dtype]}[{','.join(str(d) for d in t.shape)}]"


def collective_kind(func) -> str | None:
    """The reference's kind of a dispatched op (a ``torch._ops.OpOverload``),
    or None if it is no collective."""
    return _OP_KINDS.get((func.namespace, func.overloadpacket.__name__))


def records_from_text(hlo_text: str) -> list[dict]:
    """The collective records of an HLO module's text, by the reference's
    rules: an async pair counts once, at its -start; bytes are the result
    shape's, the lhs of ``... = shape op(...)``."""
    out = []
    for line in hlo_text.splitlines():
        if "-done(" in line:
            continue
        m = _OP_RE.search(line)
        if not m:
            continue
        lhs = re.search(r"=\s*(.*?)\s+[a-z-]+\(", line)
        shape = lhs.group(1) if lhs else ""
        out.append({"kind": m.group(1), "op": m.group(1), "shape": shape,
                    "bytes": shape_bytes(shape)})
    return out


def _records(records) -> list[dict]:
    return records_from_text(records) if isinstance(records, str) else list(records)


def collective_stats(records) -> dict:
    """Per-kind ``{count, bytes}`` of collective ops and their ``total``:
    ``records`` a traced rank's collective records, or an HLO module's text.
    One rank's traffic."""
    stats: dict[str, dict] = defaultdict(lambda: {"count": 0, "bytes": 0})
    for r in _records(records):
        stats[r["kind"]]["count"] += 1
        stats[r["kind"]]["bytes"] += r["bytes"]
    out = dict(stats)
    out["total"] = {
        "count": sum(v["count"] for v in stats.values()),
        "bytes": sum(v["bytes"] for v in stats.values()),
    }
    return out


def count_ops(records, opname: str) -> int:
    """How many records name ``opname`` as their kind or op (or, in HLO
    text, how many ``opname(`` calls it holds)."""
    if isinstance(records, str):
        return len(re.findall(rf"\b{re.escape(opname)}\(", records))
    return sum(1 for r in records if opname in (r["kind"], r["op"]))
