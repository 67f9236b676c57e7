"""End-to-end example on the PyTorch port: train a ~100M-parameter model for a
few hundred steps with the nvPAX power control loop in the loop, as
``examples/train_power_managed.py`` does for the JAX package.

The model is a 4-layer qwen3-family decoder (d_model 512 -> ~100M params
dominated by the 151936-token embedding), trained on the synthetic bigram
data.  Every control interval the simulated job's power draw goes through
the controller; the resulting caps set the DVFS step-time multiplier that a
real cluster would experience.  The model and the controller run on the
card (``--device cpu`` for the CPU).

    PYTHONPATH=src python examples/torch_train_power_managed.py --steps 200 [--device cpu]
"""

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models import build
from repro_torch.pdn.tree import build_from_level_sizes
from repro_torch.power.controller import PowerController
from repro_torch.power.power_model import DvfsModel, arch_power_profile
from repro_torch.power.straggler import straggler_report
from repro_torch.training.step import init_train_state, make_train_step


def hundred_m_config():
    base = get_arch("qwen3-4b")
    return dataclasses.replace(
        base,
        name="qwen3-100m",
        n_layers=4,
        d_model=512,
        n_heads=8,
        n_kv=4,
        d_head=64,
        d_ff=2048,
        microbatch=1,
        attn_chunk=256,
        loss_chunk=128,
        param_dtype=torch.float32,
        compute_dtype=torch.float32,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--control-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = hundred_m_config()
    api = build(cfg)
    state = init_train_state(cfg, api, torch.Generator(device=device).manual_seed(0), device)
    n_params = sum(p.numel() for p in state.params.parameters())
    print(f"model: {cfg.name}, {n_params / 1e6:.0f}M params")

    data = SyntheticLMData(cfg.vocab, seed=0)
    step_fn = make_train_step(cfg, api, lr=3e-3, warmup=20, total_steps=args.steps)

    # this job owns 64 GPUs on a shared, oversubscribed 256-GPU PDN
    pdn = build_from_level_sizes([2, 4, 4], gpus_per_server=8)
    controller = PowerController(pdn, device=device)
    job_devices = np.arange(64)
    job_of = np.zeros(pdn.n, dtype=np.int64)
    job_of[64:] = 1 + (np.arange(pdn.n - 64) // 64)
    mean_w, burst_w, burst_p = arch_power_profile(cfg.family)
    dvfs = DvfsModel()
    rng = np.random.default_rng(0)

    losses, slowdowns = [], []
    t0 = time.time()
    for step in range(args.steps):
        batch = {
            k: torch.as_tensor(v, device=device)
            for k, v in data.batch(step, args.batch, args.seq).items()
        }
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))

        if step % args.control_every == 0:
            # fleet telemetry: our job + background jobs
            draw = np.full(pdn.n, 0.0)
            draw[job_devices] = mean_w + burst_w * (rng.random(64) < burst_p)
            draw[64:] = rng.uniform(200, 680, pdn.n - 64)
            res = controller.step(draw)
            mult = dvfs.step_time_multiplier(res.allocation[job_devices])
            slowdowns.append(float(mult.max()))
            rep = straggler_report(res.allocation, job_of, dvfs)
            if step % (5 * args.control_every) == 0:
                print(
                    f"step {step:4d}  loss {losses[-1]:.3f}  "
                    f"job slowdown x{slowdowns[-1]:.3f}  "
                    f"fleet straggler tax {rep['mean_tax'] * 100:.2f}%",
                    flush=True,
                )

    print(
        f"\ntrained {args.steps} steps in {time.time() - t0:.0f}s: "
        f"loss {losses[0]:.3f} -> {losses[-1]:.3f} "
        f"(floor ~{data.bigram_entropy():.2f})\n"
        f"mean power slowdown x{np.mean(slowdowns):.3f} "
        f"(max x{np.max(slowdowns):.3f}) — nvPAX max-min fairness keeps the "
        f"synchronous job's straggler tax near zero"
    )
    return losses


if __name__ == "__main__":
    main()
