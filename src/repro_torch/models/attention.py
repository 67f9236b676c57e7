"""GQA attention with qk-norm, partial rotary, a blocked (flash) path for
long sequences and a KV-cache decode path (the port's
``repro/models/attention.py``).

Sequences longer than ``cfg.attn_chunk`` take the blocked branch, as in the
reference: with ``cfg.flash_vjp`` (the default) the flash-attention kernel
(``kernels.flash_attention``; its plain version on the CPU), without it the
plain torch blocked scan :func:`_blocked_attention`.  Where autograd records
a gradient of q, k or v, the ``flash_vjp`` branch runs
:func:`repro_torch.models.flash_vjp.blocked_attention_mo` (the kernel with
the row log-sum-exp, and a backward that recomputes the probabilities from
it); otherwise the kernel alone.  Shorter ones take :func:`_plain_attention`.
The plain paths are differentiable through autograd.  Each branch is causal
or not (an encoder's self-attention is not), and with ``memory`` (an
encoder-decoder's cross-attention) K and V come from the memory and no mask
applies.  q, k and v take the reference's sharding constraints (a no-op off
a mesh); on a mesh, each rank attends its own rows and heads with the same
branches (:func:`_sharded_attention`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import flash_vjp
from repro_torch.models.common import apply_rope, init_dense, rms_norm, rope_freqs
from repro_torch.sharding import constrain, is_distributed, split_heads

__all__ = ["KVCache", "attn_specs", "init_attn", "attn_train", "attn_decode", "init_kv_cache"]

NEG_INF = -1e30


def init_attn(generator, cfg, device=None) -> dict:
    D, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    dt = cfg.param_dtype
    p = {
        "wq": init_dense(generator, D, H * dh, dt, device),
        "wk": init_dense(generator, D, KV * dh, dt, device),
        "wv": init_dense(generator, D, KV * dh, dt, device),
        "wo": init_dense(generator, H * dh, D, dt, device, scale=(H * dh) ** -0.5),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(dh, dtype=dt, device=device)
        p["k_norm"] = torch.ones(dh, dtype=dt, device=device)
    return p


def attn_specs(cfg) -> dict:
    """The logical names of :func:`init_attn`'s weights, the reference's."""
    s = {
        "wq": ("embed", "heads_merged"),
        "wk": ("embed", "heads_merged"),
        "wv": ("embed", "heads_merged"),
        "wo": ("heads_merged", "embed"),
    }
    if cfg.qk_norm:
        s["q_norm"] = ("pos_in_head",)
        s["k_norm"] = ("pos_in_head",)
    return s


def _project_qkv(p, cfg, x, positions, *, rope=True, which="qkv"):
    """The projections named in ``which`` of ``x``, in q, k, v order (a
    cross-attention takes q of the decoder's stream and k, v of the
    memory, and computes no other)."""
    H, KV, dh = cfg.n_heads, cfg.n_kv, cfg.head_dim
    cd = cfg.compute_dtype
    if rope:
        inv, rot = rope_freqs(dh, cfg.rope_frac, cfg.rope_theta, device=x.device)
    out = []
    if "q" in which:
        q = split_heads(x @ p["wq"].to(cd), H, "q_heads")
        if cfg.qk_norm:
            q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        if rope:
            q = apply_rope(q, positions, inv, rot)
        out.append(constrain(q, "batch", None, "q_heads", None))
    if "k" in which:
        k = split_heads(x @ p["wk"].to(cd), KV, "kv_heads")
        if cfg.qk_norm:
            k = rms_norm(k, p["k_norm"], cfg.norm_eps)
        if rope:
            k = apply_rope(k, positions, inv, rot)
        out.append(constrain(k, "batch", None, "kv_heads", None))
    if "v" in which:
        v = split_heads(x @ p["wv"].to(cd), KV, "kv_heads")
        out.append(constrain(v, "batch", None, "kv_heads", None))
    return out


def _plain_attention(q, k, v, causal: bool):
    """Reference attention; used for short sequences."""
    B, S, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    kq = k.repeat_interleave(rep, dim=2) if rep > 1 else k
    vq = v.repeat_interleave(rep, dim=2) if rep > 1 else v
    logits = torch.einsum("bqhd,bkhd->bhqk", q, kq) * dh**-0.5
    if causal:
        # row i sees keys j <= i + Sk - S: the last query aligns with the last key
        mask = torch.ones(S, Sk, dtype=torch.bool, device=q.device).tril(Sk - S)
        logits = logits.masked_fill(~mask, NEG_INF)
    w = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, vq)


def _pick_chunk(seq: int, target: int) -> int:
    """Largest divisor of ``seq`` that is <= ``target`` (so ragged lengths
    like whisper's 1500 encoder frames block cleanly)."""
    c = min(seq, target)
    while seq % c:
        c -= 1
    return c


def _blocked_attention(q, k, v, causal: bool, chunk: int):
    """Flash-style two-level loop with online softmax, in plain torch.

    Memory per step: [B, H, qc, kc] logits only.  Equivalent to
    ``_plain_attention`` to within fp tolerance (asserted in tests)."""
    B, S, H, dh = q.shape
    KV = k.shape[2]
    Sk = k.shape[1]
    rep = H // KV
    scale = dh**-0.5
    qc = _pick_chunk(S, chunk)
    kc = _pick_chunk(Sk, chunk)
    outs = []
    for q0 in range(0, S, qc):
        qb = q[:, q0 : q0 + qc]
        m = torch.full((B, H, qc), -torch.inf, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, H, qc), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, qc, dh), dtype=torch.float32, device=q.device)
        for k0 in range(0, Sk, kc):
            kb, vb = k[:, k0 : k0 + kc], v[:, k0 : k0 + kc]
            kbh = kb.repeat_interleave(rep, dim=2) if rep > 1 else kb
            vbh = vb.repeat_interleave(rep, dim=2) if rep > 1 else vb
            logits = (torch.einsum("bqhd,bkhd->bhqk", qb, kbh) * scale).float()
            if causal:
                qpos = q0 + torch.arange(qc, device=q.device) + (Sk - S)
                kpos = k0 + torch.arange(kc, device=q.device)
                logits = logits.masked_fill(qpos[:, None] < kpos[None, :], NEG_INF)
            m_new = torch.maximum(m, logits.amax(-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(qb.dtype), vbh
            ).float()
            m = m_new
        out = (acc / l.clamp_min(1e-30)[..., None]).to(qb.dtype)
        outs.append(out.transpose(1, 2))  # [B, qc, H, dh]
    return torch.cat(outs, dim=1)


class KVCache(NamedTuple):
    k: torch.Tensor  # [B, S_max, KV, dh]
    v: torch.Tensor


def _attend(cfg, q, k, v, causal):
    """The attention of plain tensors q [B, S, H, dh], k and v [B, Sk, KV,
    dh], by the branches of the module's doc."""
    S, Sk = q.shape[1], k.shape[1]
    if max(S, Sk) > cfg.attn_chunk:
        if cfg.flash_vjp and torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v)):
            return flash_vjp.blocked_attention_mo(q, k, v, causal, cfg.head_dim**-0.5,
                                                  _pick_chunk(S, cfg.attn_chunk),
                                                  _pick_chunk(Sk, cfg.attn_chunk))
        if cfg.flash_vjp:
            return flash_attention(q, k, v, causal=causal)
        return _blocked_attention(q, k, v, causal, cfg.attn_chunk)
    return _plain_attention(q, k, v, causal)


def _sharded_attention(cfg, q, k, v, causal):
    """:func:`_attend` of DTensors, on each rank's own shard: rows and heads
    are independent, so each rank attends its batch rows and heads with no
    collective (``local_map``; autograd runs through it).  Where q's heads
    are split over the model axis but k's and v's are not (their count does
    not divide it), q's heads are gathered first, so that every rank keeps
    each query head beside its key head."""
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    if q.placements != k.placements or k.placements != v.placements:
        q = q.redistribute(mesh, k.placements)
        v = v.redistribute(mesh, k.placements)
    layout = list(q.placements)  # a list: local_map reads a tuple as one per output
    fn = local_map(lambda q_, k_, v_: _attend(cfg, q_, k_, v_, causal),
                   out_placements=layout, in_placements=(layout,) * 3, device_mesh=mesh)
    return fn(q, k, v)


def attn_train(p, cfg, x, positions, *, causal=True, rope=True, memory=None):
    """Full-sequence attention (training / prefill): (output, KVCache(k, v)).

    ``memory``: an optional [B, F, D] cross-attention source (the
    encoder-decoder's decoder); K and V are then projected from it, without
    rotary, and no causal mask applies."""
    B, S, D = x.shape
    if memory is None:
        q, k, v = _project_qkv(p, cfg, x, positions, rope=rope)
    else:
        (q,) = _project_qkv(p, cfg, x, positions, rope=rope, which="q")
        k, v = _project_qkv(p, cfg, memory, None, rope=False, which="kv")
        causal = False
    if is_distributed(q):
        o = _sharded_attention(cfg, q, k, v, causal)
    else:
        o = _attend(cfg, q, k, v, causal)
    # merged heads placed as ``wo``'s rows are: where the heads themselves do
    # not divide the model axis (whisper's 6 over 16), the merged dim does,
    # and a gradient split on it could not be viewed back as heads
    o = constrain(o.reshape(B, S, cfg.n_heads * cfg.head_dim), "batch", None, "heads_merged")
    return o @ p["wo"].to(cfg.compute_dtype), KVCache(k, v)


def init_kv_cache(cfg, batch, seq, device=None) -> KVCache:
    dt = cfg.compute_dtype
    shape = (batch, seq, cfg.n_kv, cfg.head_dim)
    return KVCache(
        torch.zeros(shape, dtype=dt, device=device), torch.zeros(shape, dtype=dt, device=device)
    )


def _heads_for_groups(q, groups: int):
    """A DTensor q [B, 1, H, dh] whose head dim is split over mesh ranks that
    do not divide its ``groups`` kv groups, with that dim gathered, so that
    it can be viewed as [B, 1, groups, H / groups, dh]."""
    from torch.distributed.tensor import Replicate, Shard

    split = 1
    for size, pl in zip(q.device_mesh.shape, q.placements):
        if isinstance(pl, Shard) and pl.dim == 2:
            split *= size
    if groups % split == 0:
        return q
    whole = [Replicate() if isinstance(pl, Shard) and pl.dim == 2 else pl for pl in q.placements]
    return q.redistribute(q.device_mesh, whole)


def attn_decode(p, cfg, x, pos, cache: KVCache, *, rope=True):
    """One-token decode against a KV cache.

    ``x``: [B, 1, D]; ``pos``: absolute position (an int).  The new key and
    value are written into ``cache`` in place at ``pos`` (the reference
    returns a new cache; this saves a cache-sized copy per step) and the
    same cache is returned.  Entries at index > pos are masked out."""
    B, S1, D = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv, cfg.head_dim
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions, rope=rope)
    cache.k[:, pos] = k_new[:, 0].to(cache.k.dtype)
    cache.v[:, pos] = v_new[:, 0].to(cache.v.dtype)
    k_cache = constrain(cache.k, "batch", "seq_shard", None, None)
    v_cache = constrain(cache.v, "batch", "seq_shard", None, None)
    if k_cache is not cache.k or v_cache is not cache.v:
        cache = KVCache(k_cache, v_cache)
    rep = H // KV
    if is_distributed(q):
        q = _heads_for_groups(q, KV)
    # grouped GQA: contract against the unrepeated cache
    qg = q.reshape(B, 1, KV, rep, dh)
    logits = torch.einsum("bqgrd,bsgd->bgrqs", qg, cache.k) * (dh**-0.5)
    valid = torch.arange(cache.k.shape[1], device=x.device) <= pos
    logits = logits.masked_fill(~valid, NEG_INF)
    w = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    o = torch.einsum("bgrqs,bsgd->bqgrd", w, cache.v).reshape(B, 1, H * dh)
    return o @ p["wo"].to(cfg.compute_dtype), cache
