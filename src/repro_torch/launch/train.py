"""Training launcher (the port's ``repro/launch/train.py``): the end-to-end
training entry point with checkpoint and restart, a crash drill, optional
power management and int8 gradient compression.

On the card (``--device cuda``, the default; it raises without one):
    python -m repro_torch.launch.train --arch qwen3-4b --steps 100
On the CPU (reduced config):
    python -m repro_torch.launch.train --reduced --steps 50 --device cpu

Restart drill: ``--ckpt-dir D --ckpt-every 2 --fail-at 4`` saves steps 2 and
4, then exits with code 42 as a crashed job would; the same command with
``--resume`` instead of ``--fail-at`` restores step 4 and goes on, and its
steps give the losses of a run that never stopped.  ``--compress-grads``
quantizes the gradients to int8 with error feedback before AdamW, the
error carried from step to step (the reference's jitted step traces its
hook once, so there the error stays at zero after step 0).
``--power-managed`` runs the nvPAX control loop beside training, on the
same device, and reports the DVFS step-time multiplier of its caps.
``--mesh`` past 1x1 (the reference's data x model mesh) waits for the
port's logical sharding (ROADMAP Queue 1).  Weights are drawn from a
seeded ``torch.Generator`` (seed 0) on the device.
"""

from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models import build
from repro_torch.pdn.tree import build_from_level_sizes
from repro_torch.power.controller import PowerController
from repro_torch.power.power_model import DvfsModel, arch_power_profile
from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training.compression import make_compressor
from repro_torch.training.state import TrainState
from repro_torch.training.step import init_train_state, make_train_step

__all__ = ["TrainRun", "main", "parse_args", "run"]


class TrainRun(NamedTuple):
    losses: list[float]
    grad_norms: list[float]
    slowdowns: list[float]  # the DVFS multiplier per step (1.0 without --power-managed)
    step_ms: list[float]  # host wall of each train step, ending in the loss's read back
    control_ms: list[float]  # host wall of each controller step and its multiplier
    start_step: int
    state: TrainState
    grad_err: list | None  # the carried compression error after the last step


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized config of the same family")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL axis sizes")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--power-managed", action="store_true",
                    help="run the nvPAX control loop alongside training and "
                         "report capped step-time multipliers")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="simulate a crash at this step (restart drill)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> TrainRun:
    """Train ``args.steps`` steps (from the latest checkpoint with
    ``--resume``), printing the reference's log lines."""
    if args.mesh != "1x1":
        raise NotImplementedError(
            f"--mesh {args.mesh}: sharding the train state over a data x model mesh waits for "
            "the port's logical sharding (ROADMAP Queue 1, item (a): sharding/logical, "
            "launch/mesh, launch/dryrun); run --mesh 1x1")
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    api = build(cfg)

    data = SyntheticLMData(cfg.vocab, seed=0)
    enc = (cfg.enc_frames, cfg.d_model) if cfg.is_encdec else None
    state = init_train_state(cfg, api, torch.Generator(device=device).manual_seed(0), device)

    start_step = 0
    if args.resume and args.ckpt_dir:
        latest = ckpt_lib.latest_step(args.ckpt_dir)
        if latest is not None:
            state = ckpt_lib.restore(args.ckpt_dir, latest, state, cfg=cfg)
            start_step = latest
            print(f"resumed from step {latest}")

    grad_hook = None
    comp_state = {}
    if args.compress_grads:
        init_err, apply = make_compressor(cfg)
        comp_state["err"] = init_err(state.params)

        def grad_hook(grads):  # error feedback, carried from step to step
            g_hat, comp_state["err"] = apply(grads, comp_state["err"])
            return g_hat

    step_fn = make_train_step(cfg, api, lr=args.lr, warmup=10, total_steps=args.steps,
                              grad_postprocess=grad_hook)

    controller = None
    dvfs = DvfsModel()
    if args.power_managed:
        # one PDN "job slice": enough servers for this job's devices
        pdn = build_from_level_sizes([2, 2], gpus_per_server=8)
        controller = PowerController(pdn, device=device)
        mean_w, burst_w, burst_p = arch_power_profile(cfg.family)

    losses, grad_norms, slowdowns, step_ms, control_ms = [], [], [], [], []
    t_start = time.time()
    rng = np.random.default_rng(1)
    for step in range(start_step, args.steps):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in data.batch(step, args.batch, args.seq, enc=enc).items()}
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        grad_norms.append(float(metrics["grad_norm"]))

        slowdown = 1.0
        if controller is not None:
            draw = mean_w + burst_w * (rng.random(controller.pdn.n) < burst_p)
            t0 = time.perf_counter()
            res = controller.step(draw)
            mult = dvfs.step_time_multiplier(res.allocation)  # read back to the host
            slowdown = float(mult.max())
            control_ms.append((time.perf_counter() - t0) * 1e3)
        slowdowns.append(slowdown)

        if step % args.log_every == 0 or step == args.steps - 1:
            msg = f"step {step:5d}  loss {losses[-1]:.4f}  gnorm {grad_norms[-1]:.3f}"
            if controller is not None:
                msg += f"  power-slowdown x{slowdown:.3f}"
            print(msg, flush=True)

        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt_lib.save(args.ckpt_dir, step + 1, state, cfg=cfg)

        if args.fail_at is not None and step + 1 == args.fail_at:
            print(f"simulating crash at step {step + 1}", flush=True)
            raise SystemExit(42)

    dt = time.time() - t_start
    print(f"done: {args.steps - start_step} steps in {dt:.1f}s, "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)
    return TrainRun(losses, grad_norms, slowdowns, step_ms, control_ms, start_step, state,
                    comp_state.get("err"))


def main(argv=None) -> list[float]:
    """Train and return the losses of the steps run."""
    return run(parse_args(argv)).losses


if __name__ == "__main__":
    main()
