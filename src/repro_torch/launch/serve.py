"""Serving launcher: batched prefill + decode loop with optional power caps
(the port's ``repro/launch/serve.py``).

On the card (``--device cuda``, the default; it raises without one):
    python -m repro_torch.launch.serve --arch qwen3-4b --requests 4 \
        --prompt-len 32 --gen 16 --cap 450
On the CPU (reduced config):
    python -m repro_torch.launch.serve --reduced --device cpu

``--arch`` takes every family of ``repro_torch.configs`` (dense, MoE,
Mamba-2, hybrid, encoder-decoder).  For an encoder-decoder model the
launcher draws ``enc_input`` [requests, enc_frames, d_model] from the same
numpy generator after the prompts, as the reference's does; the decode
steps, as the reference's, attend one zero frame in its place.

The prompt is fed through decode token by token, as the reference's
launcher does, so this entry point does not reach the flash-attention
kernel; ``training.step.make_serve_steps``' bulk prefill does (ROADMAP
Queue 1 item 14a has the launcher prefill in bulk).  Reports prefill and per-token
decode latency; ``--cap WATTS`` applies the
DVFS model to show capped throughput (what a datacenter-level nvPAX
allocation does to this replica).  Weights are drawn from a seeded
``torch.Generator`` (seed 0) on the device.
"""

from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.configs import get_arch
from repro_torch.models import build
from repro_torch.power.power_model import DvfsModel
from repro_torch.training.step import make_serve_steps

__all__ = ["ServeReport", "main", "parse_args", "run"]


class ServeReport(NamedTuple):
    arch: str
    device: str  # the card's name, or "cpu"
    tokens: np.ndarray  # greedy tokens [requests, gen]
    prefill_ms: float
    decode_ms_per_token: float
    tok_s: float
    cap_multiplier: float  # DVFS step-time multiplier at --cap (1.0 without one)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--cap", type=float, default=None,
                    help="per-device power cap in watts (DVFS slowdown)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> ServeReport:
    """Serve ``args.requests`` random prompts; the tokens and the timings."""
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    api = build(cfg)
    params = api.init(torch.Generator(device=device).manual_seed(0), device)
    _, decode = make_serve_steps(cfg, api)

    B, S = args.requests, args.prompt_len
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)), device=device)}
    if cfg.is_encdec:
        batch["enc_input"] = torch.as_tensor(
            rng.normal(size=(B, cfg.enc_frames, cfg.d_model)), dtype=torch.float32,
            device=device)
    tokens = batch["tokens"]

    total = S + args.gen
    caches = api.init_decode_cache(B, total, device)

    # prefill by decoding the prompt token-by-token into the cache, as the
    # reference's launcher does: this path runs no flash-attention kernel
    # (only the bulk prefill of make_serve_steps does)
    _sync(device)
    t0 = time.perf_counter()
    logits = None
    for i in range(S):
        logits, caches = decode(params, caches, tokens[:, i : i + 1], i)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    toks = []
    t0 = time.perf_counter()
    cur = torch.argmax(logits, dim=-1)
    for i in range(S, total):
        logits, caches = decode(params, caches, cur, i)
        cur = torch.argmax(logits, dim=-1)
        toks.append(cur[:, 0])
    _sync(device)
    t_decode = time.perf_counter() - t0

    mult = 1.0
    if args.cap is not None:
        mult = float(DvfsModel().step_time_multiplier(np.asarray(args.cap)))
    return ServeReport(
        arch=cfg.name,
        device=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        tokens=torch.stack(toks, 1).cpu().numpy(),
        prefill_ms=t_prefill * 1e3,
        decode_ms_per_token=t_decode * 1e3 / args.gen,
        tok_s=B * args.gen / t_decode,
        cap_multiplier=mult,
    )


def main(argv=None):
    """Serve, print the report, and return the greedy tokens [requests, gen]."""
    args = parse_args(argv)
    r = run(args)
    print(
        f"arch={r.arch} requests={args.requests} prompt={args.prompt_len} gen={args.gen} "
        f"device={r.device}\n"
        f"prefill: {r.prefill_ms:.1f} ms   "
        f"decode: {r.decode_ms_per_token:.2f} ms/token   "
        f"throughput: {r.tok_s:.1f} tok/s"
        + (
            f"\ncapped at {args.cap:.0f} W -> x{r.cap_multiplier:.2f} step time "
            f"-> {r.tok_s / r.cap_multiplier:.1f} tok/s"
            if args.cap
            else ""
        )
    )
    return r.tokens


if __name__ == "__main__":
    main()
