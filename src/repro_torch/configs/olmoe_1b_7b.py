"""olmoe-1b-7b [moe] — 16L d_model=2048 16H (MHA kv=16) d_ff=1024
vocab=50304, fine-grained MoE: 64 experts top-8 every layer
[arXiv:2409.02060].  64 experts shard 16-way on "model" (EP).
Full attention -> long_500k SKIPPED."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    d_ff=1024,
    vocab=50304,
    d_head=128,
    n_experts=64,
    top_k=8,
    moe_period=1,
    capacity_factor=1.25,
    microbatch=2,
    skip_shapes=("long_500k",),
)
