"""stablelm-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352 [hf:stabilityai/stablelm-2-12b family].  head_dim = 5120/32 =
160 (not 128 — exercises the resolver's non-128 path).
Full attention -> long_500k SKIPPED."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv=8,
    d_ff=13824,
    vocab=100352,
    d_head=160,
    microbatch=4,
    skip_shapes=("long_500k",),
)
