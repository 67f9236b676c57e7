"""Model FLOPs from a configuration's widths: the work the inputs need,
whatever implements it.

A frozen copy, adapted, of the arithmetic of
``src/repro_torch/analysis/roofline.py`` (``param_counts``, ``model_flops``;
commit d455ed1) and of PERF.md row 10's count of causal attention.  Two
departures from ``model_flops``: only weights that multiply (projections and
the output head) count, not the embedding lookup; and a prefill's head runs
on each row's last position only, since that is all a prefill returns.
Widths are read from a configuration file's ``port`` table.

- a matrix product of an ``[.., d_in]`` input by a ``[d_in, d_out]`` weight:
  2 d_in d_out a row;
- causal attention over L positions (PERF.md row 10): 4 B H dh L (L + 1) / 2
  (scores and their product with V, over the pairs at or below the
  diagonal);
- the SSD scan (arXiv:2405.21060, chunks of Q, state N, head dim P): within
  a chunk 2 (N + P) a causal pair and head (C Bᵀ, then its product with X);
  across chunks 4 N P a position and head (the chunk's state, and its
  readout); the depthwise conv 2 K a channel and position.
"""

from __future__ import annotations


def _ssd_dims(c: dict):
    d_inner = c["ssm_expand"] * c["d_model"]
    heads = d_inner // c["ssm_headdim"]
    gn = c.get("ssm_groups", 1) * c["ssm_state"]
    return d_inner, heads, c["ssm_headdim"], c["ssm_state"], gn


def layer_kinds(c: dict) -> list[str]:
    """'attn' or 'ssd' for every layer (attn_period 0: all SSD)."""
    period = c.get("attn_period", 1)
    if c.get("ssm_state", 0) and period == 0:
        return ["ssd"] * c["n_layers"]
    if c.get("ssm_state", 0) and period > 1:
        off = c.get("attn_offset", 0)
        return ["attn" if i % period == off else "ssd" for i in range(c["n_layers"])]
    return ["attn"] * c["n_layers"]


def layer_weights(c: dict, kind: str) -> int:
    """Multiplying weights of one layer (its mixer and dense feed-forward)."""
    D = c["d_model"]
    if kind == "attn":
        H, KV, dh = c["n_heads"], c["n_kv"], c["d_head"]
        mix = D * H * dh + 2 * D * KV * dh + H * dh * D
    else:
        d_inner, heads, _, _, gn = _ssd_dims(c)
        mix = D * (2 * d_inner + 2 * gn + heads) + d_inner * D
    ff = c.get("d_ff", 0)
    mlp = (3 if c.get("mlp_kind", "swiglu") == "swiglu" else 2) * D * ff if ff else 0
    return mix + mlp


def mixer_flops(c: dict, kind: str, B: int, L: int) -> float:
    """The sequence mixing of one layer beyond its weights, a forward."""
    if kind == "attn":
        return 4.0 * B * c["n_heads"] * c["d_head"] * L * (L + 1) / 2
    d_inner, heads, P, N, gn = _ssd_dims(c)
    Q = min(c["ssd_chunk"], L)
    chunks = L // Q
    intra = chunks * Q * (Q + 1) / 2 * 2 * (N + P)
    inter = L * 4 * N * P
    conv = 2.0 * c["ssm_conv"] * (d_inner + 2 * gn) * L
    return B * (heads * (intra + inter) + conv)


def forward_flops(c: dict, B: int, L: int, head_rows: int) -> float:
    """One forward over B rows of L tokens, the head on ``head_rows`` rows."""
    total = 0.0
    for kind in layer_kinds(c):
        total += 2.0 * B * L * layer_weights(c, kind) + mixer_flops(c, kind, B, L)
    return total + 2.0 * head_rows * c["d_model"] * c["vocab"]


def prefill_flops(c: dict, B: int, L: int) -> float:
    """A prefill: the head on each row's last position."""
    return forward_flops(c, B, L, head_rows=B)


def train_flops(c: dict, B: int, L: int) -> float:
    """A training step: forward and backward (twice the forward), the head
    on every position; recomputation is not the inputs' work."""
    return 3.0 * forward_flops(c, B, L, head_rows=B * L)


def attention_flops(c: dict, B: int, L: int) -> float:
    """Causal attention of one forward, all layers."""
    return sum(mixer_flops(c, k, B, L) for k in layer_kinds(c) if k == "attn")
