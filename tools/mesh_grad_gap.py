"""Where the launcher's runs part from one another in their first steps:
the losses of a few steps and, leaf by leaf, the first step's gradients
(the ones AdamW takes) of several variants of one run, each against the
same run computed in float32 and against the plain bf16 run.

Variants (``--variants``): ``bf16`` the launcher at ``--mesh 1x1``;
``f32`` the same with the config computing in float32; ``rpr`` the bf16
run with cuBLAS's reduced-precision reductions of bf16 GEMMs allowed
inside the step (PyTorch's default, which ``training.step`` turns off:
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``);
``mb2`` the bf16 run with each batch split into two microbatches;
``noflash`` the bf16 run with the attention's plain blocked path in place
of the flash kernel (``flash_vjp=False``); ``DxM`` (e.g. ``2x1``) the
launcher at that mesh, whose ranks it spawns (rank 0's own shard of each
gradient is read and held against the same slice of the reference's).
For each leaf and variant it prints the
gradient's distance from the reference's in Frobenius norm relative to
the reference's, the share of elements whose sign differs, and the
distance of AdamW's first update ``g / (|g| + eps)`` (its moments'
bias-corrected ratio at step 0) in Frobenius norm relative to the
reference's.

    python3 tools/mesh_grad_gap.py --arch whisper-tiny --batch 4 --seq 448 --full \
        --variants bf16 f32 rpr mb2 noflash 2x1 2x2
    python3 tools/mesh_grad_gap.py --device cpu --variants bf16 f32 2x1
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

EPS = 1e-8  # the launcher's AdamW eps


def capture(argv: list[str], variant: str) -> dict:
    """The launcher's run of ``argv`` as ``variant``: losses, the first
    step's gradient norm and its gradients by leaf name (on the host)."""
    import contextlib

    import torch

    from repro_torch.launch import train
    from repro_torch.training import step as step_mod

    real_arch, real_step = train.get_arch, train.make_train_step
    real_reductions = step_mod.float32_reductions
    mesh = "1x1"
    if variant == "f32":
        train.get_arch = lambda n: dataclasses.replace(real_arch(n), compute_dtype=torch.float32)
    elif variant == "mb2":
        train.get_arch = lambda n: dataclasses.replace(real_arch(n), microbatch=2)
    elif variant == "noflash":
        train.get_arch = lambda n: dataclasses.replace(real_arch(n), flash_vjp=False)
    elif variant == "rpr":
        step_mod.float32_reductions = contextlib.contextmanager(lambda: (yield))
    elif variant != "bf16":
        mesh = variant
    grads: list = []

    def step_factory(cfg, api, **kw):
        hook = kw.pop("grad_postprocess", None)

        def record(gs):
            if not grads:
                grads.append([_local(g) for g in gs])
            return hook(gs) if hook is not None else gs

        return real_step(cfg, api, grad_postprocess=record, **kw)

    train.make_train_step = step_factory
    try:
        run = train.run(train.parse_args(argv + ["--mesh", mesh]))
    finally:
        train.get_arch, train.make_train_step = real_arch, real_step
        step_mod.float32_reductions = real_reductions
    names = [n for n, _ in run.state.params.named_parameters()]
    return {"losses": run.losses, "grad_norm0": run.grad_norms[0],
            "grads": dict(zip(names, grads[0]))}


def _local(g):
    """(this rank's part of gradient ``g`` on the host, the slices of the
    whole that it holds, or None for a whole tensor)."""
    if not hasattr(g, "to_local"):
        return g.detach().float().cpu().clone(), None
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape, offset = compute_local_shape_and_global_offset(g.shape, g.device_mesh, g.placements)
    where = tuple(slice(o, o + n) for o, n in zip(offset, shape))
    return g.to_local().detach().float().cpu().clone(), where


def compare(got: dict, ref: dict) -> list[tuple]:
    """Per leaf: (name, relative gradient gap, sign-flip share, relative gap
    of AdamW's first update), the largest update gap first; a shard is held
    against the same slice of the reference's whole."""
    rows = []
    for name, (r, _) in ref.items():
        g, where = got[name]
        if where is not None:
            r = r[where]
        u, ur = g / (g.abs() + EPS), r / (r.abs() + EPS)
        rows.append((name, float((g - r).norm() / r.norm().clamp_min(1e-30)),
                     float(((g > 0) != (r > 0)).float().mean()),
                     float((u - ur).norm() / ur.norm().clamp_min(1e-30))))
    return sorted(rows, key=lambda x: -x[3])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="whisper-tiny")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=448)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true", help="the published config (else reduced)")
    ap.add_argument("--variants", nargs="+", default=["bf16", "f32", "rpr", "mb2", "2x1"])
    ap.add_argument("--top", type=int, default=6, help="leaves printed per comparison")
    ap.add_argument("--json", default=None, help="write the summary here")
    args = ap.parse_args(argv)
    base = ["--arch", args.arch, "--steps", str(args.steps), "--batch", str(args.batch),
            "--seq", str(args.seq), "--device", args.device, "--log-every", str(args.steps)]
    base += [] if args.full else ["--reduced"]
    runs = {v: capture(base, v) for v in args.variants}
    summary = {}
    for v, r in runs.items():
        print(f"{v}: losses {r['losses']} grad norm {r['grad_norm0']:.6e}", flush=True)
    for ref in ("f32", "bf16"):
        if ref not in runs:
            continue
        want = runs[ref]["losses"]
        for v, r in runs.items():
            if v == ref:
                continue
            gaps = [abs(a - b) / abs(b) for a, b in zip(r["losses"], want)]
            rows = compare(r["grads"], runs[ref]["grads"])
            tot_u = sum(x[3] ** 2 for x in rows) ** 0.5
            summary[f"{v}_vs_{ref}"] = {"loss_gaps": gaps, "leaves": rows[: args.top]}
            print(f"{v} vs {ref}: loss gaps " + ", ".join(f"{g:.3e}" for g in gaps)
                  + f"; first update's gap over the leaves (root of the sum of squares) "
                  f"{tot_u:.3e}", flush=True)
            for name, gg, flips, ug in rows[: args.top]:
                print(f"    {name:32s} grad {gg:.3e}  sign flips {flips:.3e}  update {ug:.3e}")
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
