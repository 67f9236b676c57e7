"""Blocked attention with a hand-written backward (the port's
``repro/models/flash_vjp.py``).

The forward saves only ``(q, k, v, out, lse)``, O(S d) per layer, where
autograd through the plain blocked scan would keep every chunk's
probability tile, O(S^2); the backward recomputes each tile from the row
log-sum-exp.  On a card the forward is the flash-attention kernel asked for
the row log-sum-exp (``kernels.flash_attention``, ``return_lse=True``); on
the CPU it is the reference's blocked forward in plain torch
(:func:`repro_torch.kernels.flash_attention.ref.blocked_attention_ref`).
The backward is the reference's ``_bwd_impl`` in torch ops, on both: the
reference has no backward kernel (its Pallas kernel is a forward), so its
matrix products stay ``torch.einsum``.

Math (per q-chunk i, kv-chunk j, with row stats lse):
    p_ij   = exp(q_i k_j^T * scale - lse_i)
    dv_j  += p_ij^T do_i
    dp_ij  = do_i v_j^T
    ds_ij  = p_ij * (dp_ij - rowsum(do_i * out_i))
    dq_i  += ds_ij k_j * scale
    dk_j  += ds_ij^T q_i * scale
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import NEG_INF, blocked_attention_ref

__all__ = ["blocked_attention_mo"]


def _tile_p(qb, kbh, lseb, causal, scale, q0, k0, off):
    """The probability tile exp(logits - lse) [B, H, qc, kc] in float32,
    causally hidden keys at the reference's -1e30."""
    logits = torch.einsum("bqhd,bkhd->bhqk", qb, kbh).float() * scale
    if causal:
        qpos = q0 + off + torch.arange(qb.shape[1], device=qb.device)
        kpos = k0 + torch.arange(kbh.shape[1], device=qb.device)
        logits = logits.masked_fill(qpos[:, None] < kpos[None, :], NEG_INF)
    return torch.exp(logits - lseb[..., None])


def _bwd_impl(q, k, v, out, lse, do, causal, scale, qc, kc):
    B, S, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    off = Sk - S
    f32 = torch.float32
    # delta_i = rowsum(do * out)  [B, H, S]
    delta = torch.einsum("bqhd,bqhd->bhq", do.float(), out.float())

    def repeat(t):
        return t.repeat_interleave(rep, dim=2) if rep > 1 else t

    def hidden(q0, k0):
        # every row of the q chunk hides every key of the kv chunk, and each
        # row sees some key (off >= 0), so the tile's p is exactly 0: skip it
        return causal and off >= 0 and k0 > q0 + qc - 1 + off

    # outer loop over kv chunks accumulating dk, dv; inner over q chunks
    dks, dvs = [], []
    for k0 in range(0, Sk, kc):
        kbh, vbh = repeat(k[:, k0 : k0 + kc]), repeat(v[:, k0 : k0 + kc])
        dkh = torch.zeros((B, kc, H, dh), dtype=f32, device=q.device)
        dvh = torch.zeros((B, kc, H, dh), dtype=f32, device=q.device)
        for q0 in range(0, S, qc):
            if hidden(q0, k0):
                continue
            qb, dob = q[:, q0 : q0 + qc], do[:, q0 : q0 + qc]
            p = _tile_p(qb, kbh, lse[..., q0 : q0 + qc], causal, scale, q0, k0, off)
            dvh += torch.einsum("bhqk,bqhd->bkhd", p.to(dob.dtype), dob).float()
            dp = torch.einsum("bqhd,bkhd->bhqk", dob, vbh).float()
            ds = p * (dp - delta[..., q0 : q0 + qc, None]) * scale
            dkh += torch.einsum("bhqk,bqhd->bkhd", ds.to(qb.dtype), qb).float()
        # fold the grouped heads back onto their kv heads
        if rep > 1:
            dkh = dkh.reshape(B, kc, KV, rep, dh).sum(3)
            dvh = dvh.reshape(B, kc, KV, rep, dh).sum(3)
        dks.append(dkh)
        dvs.append(dvh)
    dk = torch.cat(dks, dim=1).to(k.dtype)
    dv = torch.cat(dvs, dim=1).to(v.dtype)

    dqs = []
    for q0 in range(0, S, qc):
        qb, dob = q[:, q0 : q0 + qc], do[:, q0 : q0 + qc]
        lseb, deltab = lse[..., q0 : q0 + qc], delta[..., q0 : q0 + qc, None]
        dqb = torch.zeros((B, qc, H, dh), dtype=f32, device=q.device)
        for k0 in range(0, Sk, kc):
            if hidden(q0, k0):
                continue
            kbh, vbh = repeat(k[:, k0 : k0 + kc]), repeat(v[:, k0 : k0 + kc])
            p = _tile_p(qb, kbh, lseb, causal, scale, q0, k0, off)
            dp = torch.einsum("bqhd,bkhd->bhqk", dob, vbh).float()
            ds = p * (dp - deltab) * scale
            dqb += torch.einsum("bhqk,bkhd->bqhd", ds.to(qb.dtype), kbh).float()
        dqs.append(dqb)
    dq = torch.cat(dqs, dim=1).to(q.dtype)
    return dq, dk, dv


class _BlockedAttentionMO(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale, qc, kc):
        if q.device.type == "cpu":
            out, lse = blocked_attention_ref(q, k, v, causal, scale, qc, kc)
        else:
            if scale != q.shape[3] ** -0.5:
                raise ValueError(f"the flash kernel scales by head_dim^-0.5, not {scale}")
            out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, qc, kc)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_bwd_impl(q, k, v, out, lse, do, *ctx.args), None, None, None, None)


def blocked_attention_mo(q, k, v, causal: bool, scale: float, qc: int, kc: int):
    """q [B, S, H, dh], k and v [B, Sk, KV, dh] (H % KV == 0; S a multiple
    of ``qc``, Sk of ``kc``) -> out [B, S, H, dh] in q's dtype, differentiable
    in q, k and v.  Causal rows see keys j <= i + Sk - S."""
    if q.shape[1] % qc or k.shape[1] % kc:
        raise ValueError(f"chunks {qc}, {kc} do not divide the lengths {q.shape[1]}, {k.shape[1]}")
    return _BlockedAttentionMO.apply(q, k, v, causal, scale, qc, kc)
