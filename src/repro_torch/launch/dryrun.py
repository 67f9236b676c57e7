"""Multi-pod dry run (the port's ``repro/launch/dryrun.py``).

For every (architecture x input shape x mesh) cell, one rank of the
production mesh traces the real ``make_train_step``, prefill or decode call
on ``meta`` tensors: a ``"fake"`` process group of 256 (pod) or 512
(multipod) ranks, built inside :func:`dryrun_cell` and torn down after, a
``DeviceMesh`` on it, every weight, both AdamW moments and the batch (or,
for decode, the KV/SSM caches) as DTensors on their placements, and no
storage anywhere.  The trace runs under
:class:`repro_torch.analysis.flops.CostCounter`, which sees the rank's
local ops and collectives, and records what the reference's compiled
artifact gave it:

- ``flops`` and ``bytes_accessed``: the rank's counted FLOPs and bytes
  (:mod:`repro_torch.analysis.flops`; the flash kernel by its own count);
- ``memory``: ``argument_bytes``, the rank's own shards of the arguments
  (weights, moments, batch or caches); ``output_bytes``, its results that
  are new storage (a train step updates its state in place: only the
  metrics); ``temp_bytes``, the peak of the intermediates live at once;
- ``collectives``: :func:`repro_torch.analysis.hlo.collective_stats` of the
  rank's collectives.  The mesh lies on CPU ranks, where DTensor moves a
  shard from one dim to another by all-gather and chunk; NCCL ranks would
  take one all-to-all;
- ``roofline``: :func:`repro_torch.analysis.roofline.roofline_terms` on an
  H100;
- beside the reference's keys: ``by_op``, the flash kernel's calls and
  ``devices``, the device types of the counted ops' results (the counter
  counts the ops on ``meta`` tensors: the rank's program, not the host's
  scalar and index bookkeeping beside it).

Keys only XLA has are dropped or renamed: ``compile_s`` is ``trace_s`` (the
trace's wall time), ``xla_cost_flops_raw`` and ``generated_code_bytes`` are
gone.  Importing this module sets nothing: the reference sets ``XLA_FLAGS``
at import, the port needs no such step.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k --mesh pod
    python -m repro_torch.launch.dryrun --all [--mesh both] [--out artifacts/dryrun]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.analysis.flops import CostCounter
from repro_torch.analysis.hlo import collective_stats
from repro_torch.analysis.roofline import param_counts, roofline_terms
from repro_torch.configs import ARCHS, SHAPES, get_arch
from repro_torch.data.pipeline import batch_sharding, make_batch_specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build
from repro_torch.sharding import (
    NamedSharding,
    default_rules,
    distribute_params,
    is_distributed,
    param_sharding,
    resolve_spec,
    use_rules,
)
from repro_torch.training.optimizer import adamw_init
from repro_torch.training.state import TrainState
from repro_torch.training.step import make_serve_steps, make_train_step

__all__ = ["argument_bytes", "cache_spec_names", "cell_args", "dryrun_cell", "main"]

SKIP_REASON = ("full-attention arch; long-context cell is infeasible by design "
               "(DESIGN.md section 5)")


def cache_spec_names(shape: tuple) -> tuple:
    """The logical names of one layer's decode cache leaf, the reference's
    rule on its stacked leaf ``[units, *shape]`` without the units dim:
    KV caches [B, S, kv, dh]; SSM state [B, H, N, P]; conv window
    [B, K-1, ch]."""
    stacked = (1, *shape)
    nd = len(stacked)
    if nd == 5 and stacked[3] <= 64:
        names = (None, "batch", "seq_shard", "kv_heads", None)
    elif nd == 5:
        names = (None, "batch", "ssm_inner", None, None)
    elif nd == 4:
        names = (None, "batch", None, "ssm_inner")
    else:
        names = (None,) * nd
    return names[1:]


def _local_bytes(t) -> int:
    local = t.to_local() if is_distributed(t) else t
    return local.numel() * local.element_size()


def argument_bytes(*trees) -> int:
    """The bytes this rank holds of the tensors in ``trees`` (``Params``,
    dicts, lists, tuples of tensors): a DTensor's own shard, a plain
    tensor whole."""
    total = 0
    for tree in trees:
        if isinstance(tree, torch.nn.Module):
            total += sum(_local_bytes(p) for p in tree.parameters())
        elif isinstance(tree, dict):
            total += argument_bytes(*tree.values())
        elif isinstance(tree, (list, tuple)):
            total += argument_bytes(*tree)
        elif isinstance(tree, torch.Tensor):
            total += _local_bytes(tree)
    return total


def _placed(t: torch.Tensor, sharding: NamedSharding):
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, sharding.mesh, sharding.placements, src_data_rank=None)


def _new_outputs(result, args) -> int:
    """Bytes of the result's tensors whose storage no argument holds."""
    def locals_(x):
        out = []
        for t in torch.utils._pytree.tree_leaves(x):
            if isinstance(t, torch.nn.Module):
                out += [p for p in t.parameters()]
            elif isinstance(t, torch.Tensor):
                out.append(t)
        return [t.to_local() if is_distributed(t) else t for t in out]

    held = {t.untyped_storage()._cdata for t in locals_(args)}
    return sum(t.numel() * t.element_size() for t in locals_(result)
               if t.untyped_storage()._cdata not in held)


def cell_args(cfg, shape, rules):
    """The cell's call and its arguments, each tensor a ``meta`` DTensor on
    its placements: ``(make_train_step(...), (state, batch))``, ``(prefill,
    (params, batch))`` or ``(decode, (params, caches, tokens, pos))``."""
    api = build(cfg)
    params = api.init(torch.Generator(), "meta")
    distribute_params(params, param_sharding(api.specs(), params, rules))
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        def place(c):
            return type(c)(*(_placed(t, NamedSharding(rules.mesh, resolve_spec(
                cache_spec_names(tuple(t.shape)), tuple(t.shape), rules))) for t in c))

        caches = [place(c) for c in api.init_decode_cache(B, S, device="meta")]
        tokens = torch.empty((B, 1), dtype=torch.int32, device="meta")
        tokens = _placed(tokens, batch_sharding({"tokens": tokens}, rules)["tokens"])
        return make_serve_steps(cfg, api)[1], (params, caches, tokens, S - 1)
    batch = make_batch_specs(cfg, shape)
    if shape.kind == "prefill":
        del batch["targets"]
    sh = batch_sharding(batch, rules)
    batch = {k: _placed(v, sh[k]) for k, v in batch.items()}
    if shape.kind == "prefill":
        return make_serve_steps(cfg, api)[0], (params, batch)
    params.requires_grad_(True)
    state = TrainState(step=0, params=params, opt=adamw_init(params, cfg.opt_dtype))
    return make_train_step(cfg, api), (state, batch)


def _trace(cfg, shape, rules):
    """The cell's one traced call: (args, result, CostCounter, seconds)."""
    from torch.distributed.tensor.experimental import implicit_replication

    fn, args = cell_args(cfg, shape, rules)
    t0 = time.perf_counter()
    with use_rules(rules), implicit_replication(), \
            torch.set_grad_enabled(shape.kind == "train"), CostCounter("meta") as counter:
        result = fn(*args)
    return args, result, counter, time.perf_counter() - t0


def dryrun_cell(arch: str, shape_name: str, mesh_kind: str,
                cfg_overrides: dict | None = None) -> dict:
    """Trace one cell at one rank of a fake production mesh; returns its
    record (the reference's keys, see the module's doc)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    cfg = get_arch(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    if not cfg.runnable(shape_name):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "status": "SKIP",
                "reason": SKIP_REASON}
    if dist.is_initialized():
        raise RuntimeError("dryrun_cell builds its own fake process group; one is initialized")
    world = 512 if mesh_kind == "multipod" else 256
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multipod"), device="cpu")
        # decode steps cannot amortize FSDP weight gathers -> TP-only serving rules
        rules = default_rules(mesh, serving=(shape.kind == "decode"))
        args, result, counter, trace_s = _trace(cfg, shape, rules)
        cost = counter.cost()
        arg_bytes = argument_bytes(*args)
        out_bytes = _new_outputs(result, args)
        n_dev = mesh.size()
    finally:
        dist.destroy_process_group()
    coll = collective_stats(cost.collectives)
    rt = roofline_terms(cfg, shape, n_devices=n_dev, hlo_flops=cost.flops,
                        hlo_bytes=cost.hbm_bytes, collective_bytes=coll["total"]["bytes"])
    pc = param_counts(cfg)
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_kind,
        "status": "OK",
        "n_devices": int(n_dev),
        "trace_s": round(trace_s, 1),
        "params_total": pc["total"],
        "params_active": pc["active"],
        # per-rank numbers
        "flops": cost.flops,
        "bytes_accessed": cost.hbm_bytes,
        "by_op": cost.by_op,
        "flash_attention_calls": {k: v for k, v in cost.calls.items()
                                  if k.startswith("flash_attention")},
        "devices": list(cost.devices),
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "temp_bytes": cost.peak_bytes},
        "collectives": coll,
        "roofline": {
            "compute_s": rt.compute_s,
            "memory_s": rt.memory_s,
            "collective_s": rt.collective_s,
            "bottleneck": rt.bottleneck,
            "model_flops": rt.model_flops,
            "useful_ratio": rt.useful_ratio,
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Trace (arch x shape x mesh) cells at one rank.")
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"], default="pod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--no-flash-vjp", action="store_true",
                    help="baseline attention backward (stashes S^2 tiles)")
    args = ap.parse_args(argv)
    overrides = {"flash_vjp": False} if args.no_flash_vjp else None

    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s, m) for a in ARCHS for s in SHAPES for m in meshes]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape, m) for m in meshes]
    else:
        ap.error("give --arch and --shape, or --all")

    os.makedirs(args.out, exist_ok=True)
    ok = skip = fail = 0
    for arch, shape, m in cells:
        tag = f"{arch}__{shape}__{m}"
        try:
            rec = dryrun_cell(arch, shape, m, overrides)
        except Exception as e:  # a failure here is a bug in the port
            rec = {"arch": arch, "shape": shape, "mesh": m, "status": "FAIL",
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
        status = rec["status"]
        ok += status == "OK"
        skip += status == "SKIP"
        fail += status == "FAIL"
        extra = ""
        if status == "OK":
            extra = (f" flops={rec['flops']:.3e}"
                     f" coll={rec['collectives']['total']['bytes']:.3e}B"
                     f" trace={rec['trace_s']}s")
        elif status == "FAIL":
            extra = " " + rec["error"][:160]
        print(f"[{status}] {tag}{extra}", flush=True)
    print(f"done: {ok} OK, {skip} SKIP, {fail} FAIL")
    return 1 if fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
