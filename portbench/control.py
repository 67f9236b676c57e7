"""The controls of ``correct``: the plain reference put in the port's place
at a lower precision than the configuration states, or with a fault
planted, read by the same comparisons as a run, at the cell's own size.
Each must read past the cell's limits (``cells/<cell>.json``).

    python portbench/control.py --workload <cell> --seeds 1,2,3 [--fault F] [--tiny]

- prefill cells: the reference's forward with its matrix products on float8
  e4m3 operands (the step below bf16) for the requests a run compares: the
  first of the longest length and ``sample`` others of the first forwards;
- a ``train_pm`` cell: three float8 reference steps against three float32
  ones on the same weights and batches, and the policy reference in float32
  against float64 over as many controller steps as a run makes; ``--fault
  half`` leaves half of each batch out and takes the mean over the rest.

Prints one JSON line a seed: each number beside its limit.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def prefill_control(cell, seed, device, tiny, n_forwards=40):
    import torch

    from portbench import harness, weights as wmod
    from portbench.gen import traffic as tgen
    from portbench.reference import lm as ref

    drv = harness.driver(cell)
    p = harness.traffic_params(cell.traffic, tiny)
    port = harness.port_fields(cell.config, tiny)
    from repro_torch.models import build  # the weights' layout only

    meta = build(harness.arch(cell.config, tiny)).init(None, torch.device("meta"))
    w = wmod.make(wmod.layout(meta), cell.config["init"], seed, device)
    fwds = list(itertools.islice(tgen.forwards(p, seed), n_forwards))
    pick = np.random.default_rng(tgen.seed_seq(seed, 4))
    chosen = [next(f for f in fwds if f.length == int(tgen.lengths(p)[-1]))]
    chosen += [fwds[i] for i in pick.choice(len(fwds), int(cell.limits["sample"]), replace=False)]
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    kept = []
    with torch.no_grad():
        for f in chosen:
            toks = torch.randint(0, port["vocab"], (1, f.length), generator=gen, device=device)
            logits, caches = ref.prefill(w, port, toks, "fp8")
            kept.append(drv.Kept(f.index, toks[0], logits[0].float().cpu(),
                                 [tuple(t[0] for t in c) for c in caches]))
            del logits, caches
        values, seen = drv.compare(kept, w, port)
        return dict(values, **seen)


def train_control(cell, seed, device, tiny, fault=None):
    import torch

    from portbench import harness, weights as wmod
    from portbench.gen import pdn as pdn_gen
    from portbench.gen.telemetry import Telemetry
    from portbench.reference import lm as ref, policy
    from portbench.reference.train import Trainer
    from repro_torch.models import build  # the weights' layout only

    drv = harness.driver(cell)
    p = harness.traffic_params(cell.traffic, tiny)
    cfg = harness.arch(cell.config, tiny)
    port = harness.port_fields(cell.config, tiny)
    meta = build(cfg).init(None, torch.device("meta"))
    leaves = wmod.layout(meta)
    names = [n for n, _ in leaves]
    hyper = dict(p["optimizer"], microbatch=cfg.microbatch)
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    batches = [torch.randint(0, port["vocab"], (p["batch"], p["seq"] + 1), generator=gen,
                             device=device) for _ in range(p["reference_steps"])]

    def follow(prec, half):
        h = dict(hyper)
        if half:  # half of the batch left out, the mean over the rest
            h["microbatch"] = max(1, hyper["microbatch"] // 2)
        t = Trainer(wmod.make(leaves, cell.config["init"], seed, device), port, h, prec)
        losses, grads = [], None
        for i, seq in enumerate(batches):
            if half:
                seq = seq[: max(1, seq.shape[0] // 2)]
            out = t.step(seq[:, :-1], seq[:, 1:])
            losses.append(out["loss"])
            if i == 0:
                grads = np.array([out["grad_norms"][n] for n in names])
        w = wmod.make(leaves, cell.config["init"], seed, device)
        change = drv.leaf_norms(t.w[n] - w[n] for n in names)
        del t, w
        torch.cuda.empty_cache() if device.type == "cuda" else None
        return losses, grads, change

    base = follow("fp32", False)
    ctl = follow("fp32", True) if fault == "half" else follow("fp8", False)
    moved = base[1] >= 1e-3 * np.median(base[1])
    c = p["controller"]
    arrays = pdn_gen.build_datacenter(**c["datacenter"])
    tel = Telemetry(cell.config["family"], p["tdp_w"], arrays["dev_l"].shape[0], seed)
    gap = 0.0
    for _ in range(0 if fault else p["setup_steps"] + 15):
        d = tel.draw()
        kw = dict(margin=c["request_margin"], idle_threshold=c["idle_threshold"])
        gap = max(gap, float(np.max(np.abs(policy.allocate(arrays, d, dtype=np.float32, **kw)
                                           - policy.allocate(arrays, d, **kw)))))
    return {"loss_gap": max(abs(a - b) for a, b in zip(ctl[0], base[0])),
            "grad_gap": drv.worst_leaf_gap(ctl[1], base[1]),
            "change_gap": drv.worst_leaf_gap(ctl[2], base[2], moved),
            "alloc_gap_w": gap}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", choices=("half",), default=None)
    ap.add_argument("--tiny", action="store_true", help="the CPU tests' size, on the CPU")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench import harness

    torch.backends.cuda.matmul.allow_tf32 = False
    cell = harness.load_cell(args.workload, ROOT)
    device = torch.device("cpu") if args.tiny else harness.require_chips(cell.chips)
    for seed in (int(s) for s in args.seeds.split(",")):
        if cell.kind == "train_pm":
            values = train_control(cell, seed, device, args.tiny, args.fault)
        else:
            values = prefill_control(cell, seed, device, args.tiny)
        checks = harness.checks_from({k: v for k, v in values.items()
                                      if k in cell.limits["limits"]}, cell.limits["limits"])
        print(json.dumps({"seed": seed, "fault": args.fault, "values": values,
                          "checks": {c.name: {"value": c.value, "limit": c.limit, "ok": c.ok}
                                     for c in checks}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
