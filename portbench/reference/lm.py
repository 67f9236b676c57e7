"""Plain float32 references of the benchmark's language models: the
pre-norm decoder of grouped-query attention and SwiGLU (stablelm-12b as the
configuration file states it) and the Mamba-2 SSD stack (arXiv:2405.21060,
its minimal chunked form, ``ssd_minimal_discrete``), with their prefill
outputs (last-position logits and the caches a decode continues from) and
the next-token loss.

Matrix products run in float32 with TF32 off (the caller sets
``torch.backends.cuda.matmul.allow_tf32 = False``), or, for the control, on
operands rounded to float8 e4m3 with a scale per row of the input and per
column of the weight (``prec="fp8"``).  Weights are a dict of the
benchmark's tensors by the port's leaf names (``layers.3.attn.wq``); the
config is the configuration file's ``port`` table.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0  # largest finite float8 e4m3fn


def fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (the slice's largest magnitude maps to 448), back in float32; the
    gradient passes straight through."""
    amax = t.detach().abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    s = amax / FP8_MAX
    q = (t.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return t + (q - t.detach())


def mm(x: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "fp8":
        return fp8(x, -1) @ fp8(w, 0)
    return x @ w


def rms_norm(x, g, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * g


def rope(x, theta: float, frac: float):
    """Rotary embedding of x [B, S, H, dh] at positions 0..S-1 on the first
    ``frac`` of each head, rotating interleaved pairs (2i, 2i + 1)."""
    S, dh = x.shape[1], x.shape[-1]
    rot = int(dh * frac)
    rot -= rot % 2
    if rot == 0:
        return x
    inv = 1.0 / theta ** (torch.arange(0, rot, 2, dtype=torch.float32, device=x.device) / rot)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., 0:rot:2], x[..., 1:rot:2]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).flatten(-2)
    return torch.cat([out, x[..., rot:]], dim=-1)


def causal_attention(q, k, v, block: int = 512):
    """softmax(q kᵀ / sqrt(dh), causal) v over query blocks; each query head
    h reads key/value head h // (H / KV)."""
    B, S, H, dh = q.shape
    rep = H // k.shape[2]
    k = k.repeat_interleave(rep, dim=2).transpose(1, 2)  # [B, H, S, dh]
    v = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    q = q.transpose(1, 2)
    out = []
    for q0 in range(0, S, block):
        qb = q[:, :, q0:q0 + block]
        s = qb @ k.transpose(-1, -2) * dh ** -0.5
        rows = torch.arange(q0, q0 + qb.shape[2], device=q.device)[:, None]
        s = s.masked_fill(rows < torch.arange(S, device=q.device)[None, :], float("-inf"))
        out.append(torch.softmax(s, dim=-1) @ v)
    return torch.cat(out, dim=2).transpose(1, 2)


def attn_layer(w, c, x, prec):
    """One decoder layer; returns (x, (k, v) after the rotary)."""
    B, S, _ = x.shape
    H, KV, dh = c["n_heads"], c["n_kv"], c["d_head"]
    h = rms_norm(x, w["ln1"], c["norm_eps"])
    q = mm(h, w["attn.wq"], prec).view(B, S, H, dh)
    k = mm(h, w["attn.wk"], prec).view(B, S, KV, dh)
    v = mm(h, w["attn.wv"], prec).view(B, S, KV, dh)
    q = rope(q, c["rope_theta"], c["rope_frac"])
    k = rope(k, c["rope_theta"], c["rope_frac"])
    o = causal_attention(q, k, v).reshape(B, S, H * dh)
    x = x + mm(o, w["attn.wo"], prec)
    h = rms_norm(x, w["ln2"], c["norm_eps"])
    g = F.silu(mm(h, w["mlp.wg"], prec)) * mm(h, w["mlp.wu"], prec)
    return x + mm(g, w["mlp.wd"], prec), (k, v)


def segsum(a):
    """[..., T] -> [..., T, T]: out[i, j] = a[j+1] + ... + a[i] for j <= i,
    -inf above the diagonal (the paper's stable segment sum)."""
    T = a.shape[-1]
    a = a[..., None].expand(*a.shape, T)
    below = torch.ones(T, T, dtype=torch.bool, device=a.device).tril(-1)
    a = a.masked_fill(~below, 0.0)
    s = torch.cumsum(a, dim=-2)
    return s.masked_fill(~torch.ones(T, T, dtype=torch.bool, device=a.device).tril(), float("-inf"))


def ssd(X, A, Bm, Cm, block: int):
    """The minimal chunked SSD of arXiv:2405.21060 (``ssd_minimal_discrete``):
    X [b, s, h, p] (inputs times dt), A [b, s, h] (A times dt), Bm and Cm
    [b, s, h, n].  Returns (Y [b, s, h, p], final state [b, h, p, n])."""
    b, s, h, p = X.shape
    c = s // block
    X, Bm, Cm = (t.reshape(b, c, block, *t.shape[2:]) for t in (X, Bm, Cm))
    A = A.reshape(b, c, block, h).permute(0, 3, 1, 2)  # [b, h, c, l]
    A_cum = torch.cumsum(A, dim=-1)
    L = torch.exp(segsum(A))
    Y_diag = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp", Cm, Bm, L, X)
    decay_states = torch.exp(A_cum[..., -1:] - A_cum)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", Bm, decay_states, X)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    decay_chunk = torch.exp(segsum(F.pad(A_cum[..., -1], (1, 0))))
    new_states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)
    states, final = new_states[:, :-1], new_states[:, -1]
    Y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", Cm, states, torch.exp(A_cum))
    return (Y_diag + Y_off).reshape(b, s, h, p), final


def ssd_layer(w, c, x, prec):
    """One Mamba-2 mixer block; returns (x, (state [b, h, n, p], the last
    K - 1 conv inputs))."""
    b, s, D = x.shape
    d_inner = c["ssm_expand"] * D
    P, N, K = c["ssm_headdim"], c["ssm_state"], c["ssm_conv"]
    G = c.get("ssm_groups", 1)
    H = d_inner // P
    h = rms_norm(x, w["ln1"], c["norm_eps"])
    proj = mm(h, w["ssd.in_proj"], prec)
    z = proj[..., :d_inner]
    xbc_in = proj[..., d_inner:2 * d_inner + 2 * G * N]
    dt = F.softplus(proj[..., -H:] + w["ssd.dt_bias"])
    conv_w = w["ssd.conv_w"].t().unsqueeze(1)  # [channels, 1, K]
    xbc = F.conv1d(F.pad(xbc_in.transpose(1, 2), (K - 1, 0)), conv_w, w["ssd.conv_b"],
                   groups=conv_w.shape[0]).transpose(1, 2)
    xbc = F.silu(xbc)
    xs = xbc[..., :d_inner].reshape(b, s, H, P)
    Bm = xbc[..., d_inner:d_inner + G * N].reshape(b, s, G, N).repeat_interleave(H // G, 2)
    Cm = xbc[..., d_inner + G * N:].reshape(b, s, G, N).repeat_interleave(H // G, 2)
    A = -torch.exp(w["ssd.A_log"])
    y, state = ssd(xs * dt[..., None], A * dt, Bm, Cm, min(c["ssd_chunk"], s))
    y = y + w["ssd.Dp"][:, None] * xs
    y = rms_norm(y.reshape(b, s, d_inner) * F.silu(z), w["ssd.norm_g"], c["norm_eps"])
    return x + mm(y, w["ssd.out_proj"], prec), (state.transpose(-1, -2), xbc_in[:, s - (K - 1):])


def _layer_weights(weights: dict, i: int) -> dict:
    pre = f"layers.{i}."
    return {k[len(pre):]: v for k, v in weights.items() if k.startswith(pre)}


def _kinds(c):
    from portbench.counts.flops import layer_kinds

    return layer_kinds(c)


def hidden(weights, c, tokens, prec="fp32", caches=None, remat=False):
    """Final normed hidden states [b, s, D] of the stack over tokens [b, s];
    each layer's cache appended to ``caches`` when given."""
    x = weights["tok_embed"][tokens]
    for i, kind in enumerate(_kinds(c)):
        w = _layer_weights(weights, i)
        fn = attn_layer if kind == "attn" else ssd_layer
        if remat and torch.is_grad_enabled():
            x, cache = checkpoint(fn, w, c, x, prec, use_reentrant=False)
        else:
            x, cache = fn(w, c, x, prec)
        if caches is not None:
            caches.append(tuple(t.detach() for t in cache))
    return rms_norm(x, weights["final_norm"], c["norm_eps"])


def head(weights, c):
    return weights["tok_embed"].t() if c.get("tie_embeddings") else weights["lm_head"]


@torch.no_grad()
def prefill(weights, c, tokens, prec="fp32"):
    """(last-position logits [b, vocab], per-layer caches) of a prompt."""
    caches = []
    x = hidden(weights, c, tokens, prec, caches)
    return mm(x[:, -1], head(weights, c), prec), caches


def loss(weights, c, tokens, targets, prec="fp32", remat=True):
    """Mean next-token cross-entropy over every position."""
    x = hidden(weights, c, tokens, prec, remat=remat)
    logits = mm(x, head(weights, c), prec)
    return F.cross_entropy(logits.flatten(0, 1), targets.flatten().long())
