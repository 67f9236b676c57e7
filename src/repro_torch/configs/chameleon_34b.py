"""chameleon-34b [vlm] — early-fusion multimodal decoder.

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536 [arXiv:2405.09818].
Early fusion means VQ-VAE image tokens are ordinary ids in the shared
65536 vocab; the vision tokenizer frontend is a STUB (the backbone consumes
token ids directly).  qk-norm per the paper's training-stability fix.
Full attention -> long_500k is SKIPPED (recorded in DESIGN.md).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    d_ff=22016,
    vocab=65536,
    d_head=128,
    qk_norm=True,
    microbatch=8,
    skip_shapes=("long_500k",),
)
