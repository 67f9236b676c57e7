"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536 [arXiv:2403.19887].
Repeating unit of 8 layers: attention at in-unit position 3, Mamba
elsewhere; MoE replaces the dense FFN on odd layers (every 2nd).  The Mamba
layers use our SSD (mamba-2) block — hardware adaptation recorded in
DESIGN.md.  Hybrid 1:7 attention => sub-quadratic; long_500k RUNS.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    d_ff=14336,
    vocab=65536,
    d_head=128,
    n_experts=16,
    top_k=2,
    moe_period=2,
    moe_offset=1,
    attn_period=8,
    attn_offset=3,
    ssm_state=16,
    ssm_expand=2,
    ssm_headdim=64,
    microbatch=8,
)
