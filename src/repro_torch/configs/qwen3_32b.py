"""qwen3-32b [dense] — 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936, qk_norm, head_dim=128 [hf:Qwen/Qwen3-8B family].
Full attention -> long_500k SKIPPED."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv=8,
    d_ff=25600,
    vocab=151936,
    d_head=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    microbatch=8,
    skip_shapes=("long_500k",),
)
