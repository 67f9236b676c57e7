"""Serve a small model with batched requests under datacenter power caps, on
the PyTorch port.

Shows the serving side of the power loop: a replica's decode throughput
under the cap nvPAX assigns to its device, across a sweep of fleet load
levels (heavier fleet -> tighter caps -> slower tokens), as
``examples/serve_capped.py`` shows it for the JAX package.  The replica and
the controller run on the card (``--device cpu`` for the CPU).

    PYTHONPATH=src python examples/torch_serve_capped.py [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.configs import get_arch
from repro_torch.models import build
from repro_torch.pdn.tree import build_from_level_sizes
from repro_torch.power.controller import PowerController
from repro_torch.power.power_model import DvfsModel
from repro_torch.training.step import make_serve_steps


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_arch("qwen3-4b").reduced()
    api = build(cfg)
    params = api.init(torch.Generator(device=device).manual_seed(0), device)
    _, decode = make_serve_steps(cfg, api)

    B, S, G = 4, 32, 32
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (B, 1)), device=device)
    caches = api.init_decode_cache(B, S + G, device)

    # measure uncapped decode
    cur = toks
    _sync(device)
    t0 = time.perf_counter()
    for i in range(G):
        logits, caches = decode(params, caches, cur, i)
        cur = torch.argmax(logits, -1)
    _sync(device)
    base_tok_s = B * G / (time.perf_counter() - t0)

    # our replica is device 0 of a shared 128-GPU PDN
    pdn = build_from_level_sizes([2, 2, 4], gpus_per_server=4)
    controller = PowerController(pdn, device=device)
    dvfs = DvfsModel()
    print(f"replica uncapped: {base_tok_s:.1f} tok/s")
    print(f"{'fleet load':>12} {'our cap':>9} {'slowdown':>9} {'tok/s':>8}")
    for load in (300.0, 450.0, 550.0, 650.0):
        draw = np.full(pdn.n, load)
        draw[0] = 420.0  # decode replica draws less (memory-bound)
        res = controller.step(draw, active=np.ones(pdn.n, bool))
        cap = res.allocation[0]
        mult = float(dvfs.step_time_multiplier(np.asarray(cap)))
        print(
            f"{load:>10.0f} W {cap:>7.0f} W x{mult:>7.3f} "
            f"{base_tok_s / mult:>8.1f}"
        )


if __name__ == "__main__":
    main()
