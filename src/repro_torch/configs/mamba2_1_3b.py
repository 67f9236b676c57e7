"""mamba2-1.3b [ssm] — attention-free SSD (state-space duality).

48L d_model=2048 vocab=50280 ssm_state=128 [arXiv:2405.21060].
d_inner = 2*2048 = 4096, headdim 64 -> 64 SSD heads (shard on "model").
Mixer-only blocks (d_ff=0, no FFN sublayer) per the published config.
Attention-free -> long_500k RUNS (constant-size state, O(1) decode)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=1,  # unused (attention-free)
    n_kv=1,
    d_ff=0,  # mixer-only blocks
    vocab=50280,
    d_head=64,
    attn_period=0,  # every layer is SSD
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    microbatch=2,
)
