"""chatglm3-6b [dense] — 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024 [arXiv:2406.12793].  '2d RoPE': rotary applied to half of each
head dim (rope_frac=0.5).  Full attention -> long_500k SKIPPED."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv=2,
    d_ff=13696,
    vocab=65024,
    d_head=128,
    rope_frac=0.5,
    microbatch=4,
    skip_shapes=("long_500k",),
)
