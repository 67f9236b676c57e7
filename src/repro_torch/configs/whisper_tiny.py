"""whisper-tiny [audio] — encoder-decoder, conv frontend STUB.

4L encoder + 4L decoder, d_model=384 6H (kv=6) d_ff=1536 vocab=51865
[arXiv:2212.04356].  The conv1d+GELU audio frontend is a stub:
``input_specs()`` provides precomputed frame embeddings
[B, 1500, 384] (what the frontend produces from 30 s of log-mel).
GELU MLP, sinusoidal positions, no rotary.  6 heads don't divide the
16-way model axis -> heads replicate, d_ff=1536 shards (resolver).
Enc-dec with decode step -> decode shapes RUN; full attention ->
long_500k SKIPPED."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,  # decoder layers
    enc_layers=4,
    enc_frames=1500,
    d_model=384,
    n_heads=6,
    n_kv=6,
    d_ff=1536,
    vocab=51865,
    d_head=64,
    mlp_kind="gelu",
    rope_frac=0.0,  # no rotary
    microbatch=1,
    skip_shapes=("long_500k",),
)
