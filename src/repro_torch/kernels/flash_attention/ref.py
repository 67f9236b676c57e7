"""Plain PyTorch versions of the flash-attention kernel.

:func:`attention_ref`: softmax attention with the whole logits matrix (the
reference's ``attention_ref``), the CPU path of :mod:`.ops` and the oracle
the CUDA kernels' ``out`` is held against.  :func:`blocked_attention_ref`:
the reference's blocked forward under its hand-written VJP
(``repro/models/flash_vjp.py``, ``_fwd_impl``), an online softmax over
query and key chunks returning ``(out, lse)``; the CPU forward of
``models.flash_vjp`` and the yardstick of the kernels' ``lse``."""

from __future__ import annotations

import torch

__all__ = ["attention_ref", "blocked_attention_ref"]

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal=True, return_lse=False):
    """q: [B,Sq,H,dh]; k,v: [B,Sk,KV,dh] (GQA: H % KV == 0).

    Causal rows align the last query with the last key (offset Sk - Sq);
    a row that sees no key (Sq > Sk) gets the mean of V.  With
    ``return_lse``, ``(out, lse)``: lse [B, H, Sq] the rows' log-sum-exp of
    the scaled, masked logits in float32."""
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
    out = torch.einsum("bhqk,bkhd->bqhd", w.to(q.dtype), vq)
    return (out, torch.logsumexp(logits, dim=-1)) if return_lse else out


def blocked_attention_ref(q, k, v, causal: bool, scale: float, qc: int, kc: int):
    """The reference's ``_fwd_impl``: q [B,S,H,dh], k,v [B,Sk,KV,dh], S a
    multiple of ``qc`` and Sk of ``kc`` -> (out [B,S,H,dh] in q's dtype, lse
    [B,H,S] in float32).  Per query chunk an online softmax over the key
    chunks in float32 (logits accumulated in q's dtype, then scaled in
    float32; P rounded to v's dtype for P V); causal rows see keys j <= i +
    Sk - S, hidden keys at -1e30; lse = m + log(max(l, 1e-30))."""
    B, S, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    off = Sk - S
    f32 = torch.float32
    outs, lses = [], []
    for q0 in range(0, S, qc):
        qb = q[:, q0 : q0 + qc]
        m = torch.full((B, H, qc), -torch.inf, dtype=f32, device=q.device)
        l = torch.zeros((B, H, qc), dtype=f32, device=q.device)
        acc = torch.zeros((B, H, qc, dh), dtype=f32, device=q.device)
        for k0 in range(0, Sk, kc):
            kb, vb = k[:, k0 : k0 + kc], v[:, k0 : k0 + kc]
            kbh = kb.repeat_interleave(rep, dim=2) if rep > 1 else kb
            vbh = vb.repeat_interleave(rep, dim=2) if rep > 1 else vb
            logits = torch.einsum("bqhd,bkhd->bhqk", qb, kbh).to(f32) * scale
            if causal:
                qpos = q0 + off + torch.arange(qc, device=q.device)
                kpos = k0 + torch.arange(kc, device=q.device)
                logits = logits.masked_fill(qpos[:, None] < kpos[None, :], NEG_INF)
            m_new = torch.maximum(m, logits.amax(-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(qb.dtype), vbh).to(f32)
            m = m_new
        l = l.clamp_min(1e-30)
        outs.append((acc / l[..., None]).to(qb.dtype).transpose(1, 2))  # [B, qc, H, dh]
        lses.append(m + torch.log(l))
    return torch.cat(outs, dim=1), torch.cat(lses, dim=-1)
