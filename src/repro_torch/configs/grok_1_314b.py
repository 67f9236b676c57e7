"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2 on every layer [hf:xai-org/grok-1].

8 experts do not divide the 16-way model axis -> the divisibility-aware
resolver falls back to replicated expert dim with the 32768-wide ff dim
sharded on "model" instead (DESIGN.md section 7).  Parameters/optimizer in
bf16 moments to fit the 314B parameter state on a single 256-chip pod.
Full attention -> long_500k SKIPPED."""

import torch

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv=8,
    d_ff=32768,
    vocab=131072,
    d_head=128,
    n_experts=8,
    top_k=2,
    moe_period=1,
    param_dtype=torch.bfloat16,
    opt_dtype=torch.bfloat16,
    microbatch=16,
    skip_shapes=("long_500k",),
)
