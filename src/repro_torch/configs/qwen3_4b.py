"""qwen3-4b [dense] — 36L d_model=2560 32H (GQA kv=8) d_ff=9728
vocab=151936, qk_norm, head_dim=128 [hf:Qwen/Qwen3-8B family].
Full attention -> long_500k SKIPPED."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv=8,
    d_ff=9728,
    vocab=151936,
    d_head=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    microbatch=4,
    skip_shapes=("long_500k",),
)
