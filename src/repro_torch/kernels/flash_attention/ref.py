"""Plain PyTorch version of the flash-attention kernel: softmax attention
with the whole logits matrix (the reference's ``attention_ref``).  The CPU
path of :mod:`.ops` and the oracle the CUDA kernel is held against."""

from __future__ import annotations

import torch

__all__ = ["attention_ref"]

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal=True):
    """q: [B,Sq,H,dh]; k,v: [B,Sk,KV,dh] (GQA: H % KV == 0).

    Causal rows align the last query with the last key (offset Sk - Sq);
    a row that sees no key (Sq > Sk) gets the mean of V."""
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    kq = k.repeat_interleave(rep, dim=2) if rep > 1 else k
    vq = v.repeat_interleave(rep, dim=2) if rep > 1 else v
    logits = torch.einsum("bqhd,bkhd->bhqk", q, kq).float() * dh**-0.5
    if causal:
        mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).tril(Sk - Sq)
        logits = logits.masked_fill(~mask, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(q.dtype), vq)
