"""Mamba-2 SSD (state-space duality) block: the chunked prefill path and the
recurrent decode path (the port's ``repro/models/ssm.py``).

The scalar-A SSD of arXiv:2405.21060 in the reference's form: within each
chunk of ``cfg.ssd_chunk`` positions, ``[Q, Q]`` and ``[N, P]`` contractions;
across chunks, one loop carrying the state ``h`` ``[B, H, N, P]``.  The
reference computes it with ``jnp.einsum`` and a ``lax.scan``, outside any
Pallas kernel; here ``torch.einsum`` and a Python loop over the chunks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import init_dense, rms_norm
from repro_torch.sharding import constrain, is_distributed

__all__ = ["SSMCache", "init_ssd", "init_ssm_cache", "ssd_decode", "ssd_specs", "ssd_train"]


def _dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    H = d_inner // cfg.ssm_headdim
    return d_inner, H, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_groups


def init_ssd(generator, cfg, device=None) -> dict:
    D = cfg.d_model
    d_inner, H, P, N, G = _dims(cfg)
    conv_ch = d_inner + 2 * G * N
    d_proj = 2 * d_inner + 2 * G * N + H
    dt = cfg.param_dtype
    conv_w = torch.randn((cfg.ssm_conv, conv_ch), generator=generator, dtype=torch.float32,
                         device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": init_dense(generator, D, d_proj, dt, device),
        "conv_w": conv_w.mul_(0.2).to(dt),
        "conv_b": torch.zeros(conv_ch, dtype=dt, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "Dp": torch.ones(H, **f32),
        "dt_bias": torch.log(torch.expm1(torch.full((H,), 0.01, **f32))),
        "norm_g": torch.ones(d_inner, dtype=dt, device=device),
        "out_proj": init_dense(generator, d_inner, D, dt, device, scale=d_inner**-0.5),
    }


def ssd_specs(cfg) -> dict:
    """The logical names of :func:`init_ssd`'s weights, the reference's."""
    return {
        "in_proj": ("embed", "ssm_inner"),
        "conv_w": (None, "ssm_inner"),
        "conv_b": ("ssm_inner",),
        "A_log": ("ssm_inner",),
        "Dp": ("ssm_inner",),
        "dt_bias": ("ssm_inner",),
        "norm_g": ("ssm_inner",),
        "out_proj": ("ssm_inner", "embed"),
    }


def _split_proj(p, cfg, x):
    """x [B, S, D] -> z, xbc (before the conv), dt_raw."""
    d_inner, H, P, N, G = _dims(cfg)
    proj = x @ p["in_proj"].to(cfg.compute_dtype)
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner : 2 * d_inner + 2 * G * N]
    dt_raw = proj[..., -H:]
    return z, xbc, dt_raw


def _causal_conv(p, cfg, xbc):
    """Depthwise causal conv1d over the sequence, [B, S, ch] -> [B, S, ch]:
    out[t] = sum over k of w[k] * in[t + k - (K - 1)], zeros before the
    start, then the bias and SiLU."""
    K = cfg.ssm_conv
    S = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    w = p["conv_w"].to(xbc.dtype)
    out = pad[:, 0:S] * w[0]
    for k in range(1, K):
        out = out + pad[:, k : k + S] * w[k]
    return F.silu(out + p["conv_b"].to(xbc.dtype))


def _ssd_scan(cfg, xh, dt, A, Bh, Ch):
    """Chunked SSD: xh [B, S, H, P], dt [B, S, H] (after the softplus), A
    [H] (< 0), Bh/Ch [B, S, H, N].  Returns (y [B, S, H, P] in float32, the
    final state [B, H, N, P])."""
    B, S, H, P = xh.shape
    N = Bh.shape[-1]
    Q = min(cfg.ssd_chunk, S)
    if S % Q:
        raise ValueError(f"seq {S} is not divisible by ssd_chunk {Q}")
    nc = S // Q
    f32 = torch.float32
    a = (dt.to(f32) * A.to(f32)).reshape(B, nc, Q, H)
    ac = torch.cumsum(a, dim=2)  # [B, nc, Q, H]
    a_last = ac[:, :, -1:, :]  # [B, nc, 1, H]

    Xc = xh.reshape(B, nc, Q, H, P).to(f32)
    Bc = Bh.reshape(B, nc, Q, H, N).to(f32)
    Cc = Ch.reshape(B, nc, Q, H, N).to(f32)
    dtc = dt.reshape(B, nc, Q, H).to(f32)

    # within a chunk (quadratic in Q)
    CB = torch.einsum("bcihn,bcjhn->bchij", Cc, Bc)
    act = ac.permute(0, 1, 3, 2)  # [B, nc, H, Q]
    decay = torch.exp(act[..., :, None] - act[..., None, :])  # exp(ac_i - ac_j)
    mask = torch.ones(Q, Q, dtype=torch.bool, device=xh.device).tril()
    M = torch.where(mask, CB * decay, 0.0)
    M = M * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]  # weighted by dt_j
    y_intra = torch.einsum("bchij,bcjhp->bcihp", M, Xc)

    # each chunk's contribution to the state at its end
    decay_to_end = torch.exp(a_last - ac)  # [B, nc, Q, H]
    Bw = Bc * (dtc * decay_to_end)[..., None]
    T = torch.einsum("bcjhn,bcjhp->bchnp", Bw, Xc)  # [B, nc, H, N, P]

    # across chunks: the state carried from chunk to chunk
    h = torch.zeros((B, H, N, P), dtype=f32, device=xh.device)
    y_inter = []
    for c in range(nc):
        y_inter.append(
            torch.einsum("bihn,bhnp->bihp", Cc[:, c] * torch.exp(ac[:, c])[..., None], h)
        )
        h = h * torch.exp(a_last[:, c]).transpose(1, 2)[..., None] + T[:, c]
    y = y_intra + torch.stack(y_inter, dim=1)
    return y.reshape(B, S, H, P), h


def _sharded_scan(cfg, xh, dt, A, Bh, Ch):
    """:func:`_ssd_scan` of DTensors, on each rank's own batch rows and heads
    (``local_map``; autograd runs through it): the scan mixes neither.  dt,
    B and C take xh's placements, A its heads'; A, whole on a mesh dim that
    splits the rows, gets from each rank the gradient of its own rows, a
    partial sum."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = xh.device_mesh
    lay = list(xh.placements)  # rows (dim 0) and heads (dim 2) of xh, dt, B and C
    if any(pl not in (Replicate(), Shard(0), Shard(2)) for pl in lay):
        raise ValueError(f"SSD inputs placed {lay}: expected row and head shards")
    lay_a = [Shard(0) if pl == Shard(2) else Replicate() for pl in lay]
    grad_a = [Partial() if pl == Shard(0) else a for pl, a in zip(lay, lay_a)]
    lay_h = [Shard(1) if pl == Shard(2) else pl for pl in lay]  # the state [B, H, N, P]
    dt, Bh, Ch = (t.redistribute(mesh, lay) for t in (dt, Bh, Ch))
    A = A.redistribute(mesh, lay_a)
    fn = local_map(lambda *a: _ssd_scan(cfg, *a), out_placements=(lay, lay_h),
                   in_placements=(lay, lay, lay_a, lay, lay),
                   in_grad_placements=(lay, lay, grad_a, lay, lay), device_mesh=mesh)
    return fn(xh, dt, A, Bh, Ch)


class SSMCache(NamedTuple):
    h: torch.Tensor  # [B, H, N, P] float32 state
    conv: torch.Tensor  # [B, K - 1, conv_ch]: the last K - 1 conv inputs


def init_ssm_cache(cfg, batch, device=None) -> SSMCache:
    d_inner, H, P, N, G = _dims(cfg)
    conv_ch = d_inner + 2 * G * N
    return SSMCache(
        h=torch.zeros((batch, H, N, P), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=cfg.compute_dtype,
                         device=device),
    )


def _heads(cfg, xbc, lead):
    """The conv output split into x [*lead, H, P] and B, C [*lead, H, N]
    (each of the G groups' B and C repeated over its H / G heads)."""
    d_inner, H, P, N, G = _dims(cfg)
    xh = xbc[..., :d_inner].reshape(*lead, H, P)
    Bm = xbc[..., d_inner : d_inner + G * N].reshape(*lead, G, N)
    Cm = xbc[..., d_inner + G * N :].reshape(*lead, G, N)
    rep = H // G
    return xh, Bm.repeat_interleave(rep, dim=-2), Cm.repeat_interleave(rep, dim=-2)


def ssd_train(p, cfg, x):
    """x: [B, S, D] -> (y [B, S, D], SSMCache to continue from by decode)."""
    d_inner, H, P, N, G = _dims(cfg)
    cd = cfg.compute_dtype
    B_, S, _ = x.shape
    z, xbc_pre, dt_raw = _split_proj(p, cfg, x)
    xbc = _causal_conv(p, cfg, xbc_pre)
    xh, Bh, Ch = _heads(cfg, xbc, (B_, S))
    xh = constrain(xh, "batch", None, "ssm_inner", None)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    scan = _sharded_scan if is_distributed(xh) else _ssd_scan
    y, h_final = scan(cfg, xh, dt, A, Bh, Ch)
    y = y + p["Dp"][None, None, :, None] * xh.float()
    y = y.reshape(B_, S, d_inner).to(cd)
    y = rms_norm(y * F.silu(z), p["norm_g"], cfg.norm_eps)
    cache = SSMCache(h=h_final, conv=xbc_pre[:, S - (cfg.ssm_conv - 1) :, :])
    return y @ p["out_proj"].to(cd), cache


def ssd_decode(p, cfg, x, cache: SSMCache):
    """One-token recurrent step.  x: [B, 1, D] -> (y [B, 1, D], the new
    cache)."""
    d_inner, H, P, N, G = _dims(cfg)
    cd = cfg.compute_dtype
    f32 = torch.float32
    z, xbc_new, dt_raw = _split_proj(p, cfg, x)  # [B, 1, ...]
    # the conv over the last K inputs: the cache's K - 1 and the new one
    window = torch.cat([cache.conv, xbc_new.to(cache.conv.dtype)], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", window.to(cd), p["conv_w"].to(cd)) + p[
        "conv_b"
    ].to(cd)
    xbc = F.silu(conv_out)[:, None, :]  # [B, 1, ch]
    xh, Bh, Ch = _heads(cfg, xbc[:, 0], (-1,))
    Bh, Ch = Bh.to(f32), Ch.to(f32)
    dt = F.softplus(dt_raw[:, 0].to(f32) + p["dt_bias"])  # [B, H]
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A)  # [B, H]
    h = cache.h * dA[..., None, None] + torch.einsum(
        "bhn,bhp->bhnp", Bh * dt[..., None], xh.to(f32)
    )
    y = torch.einsum("bhn,bhnp->bhp", Ch, h) + p["Dp"][None, :, None] * xh.to(f32)
    y = y.reshape(-1, 1, d_inner).to(cd)
    y = rms_norm(y * F.silu(z), p["norm_g"], cfg.norm_eps)
    return y @ p["out_proj"].to(cd), SSMCache(h=h, conv=window[:, 1:, :])
