"""ctypes wrapper of the CUDA flash-attention kernel
(``csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention/kernel.py:flash_attention``
(Pallas, TPU).  The source's header comment gives the design and what bounds
it.  The wrapper checks its inputs, allocates the output with
``torch.empty``, launches on the current stream, raises on a non-zero
``cudaGetLastError``, and counts its launches in :data:`LAUNCHES`.

Inputs are read in place through their strides (batch, sequence, head; the
head dimension must be contiguous), so GQA reads K/V head ``h // (H / KV)``
without repeating it.  A tensor whose head dimension is strided, whose other
strides are not whole 16-byte steps, or whose data is not 16-byte aligned is
first copied with ``clone(memory_format=torch.contiguous_format)``; the
model's q/k/v never are.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["LAUNCHES", "flash_attention"]

LAUNCHES = {"flash_attention": 0}

_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
# the head dims ``dispatch_head_dim`` in csrc/flash_attention.cu builds kernels for
HEAD_DIMS = (32, 64, 128, 160)


def _strided(name: str, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if t.device != like.device or t.dtype != like.dtype:
        raise ValueError(f"{name} must be {like.dtype} on {like.device}, got {t.dtype} on {t.device}")
    if t.ndim != 4:
        raise ValueError(f"{name} must be [B, S, heads, head_dim], got {tuple(t.shape)}")
    per_16b = 16 // t.element_size()
    if (
        t.stride(3) == 1
        and all(s % per_16b == 0 for s in t.stride()[:3])
        and t.data_ptr() % 16 == 0
    ):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def flash_attention(q, k, v, *, causal=True):
    """q: [B,Sq,H,dh]; k,v: [B,Sk,KV,dh] (H % KV == 0) -> [B,Sq,H,dh] in
    q's dtype (bfloat16 or float32)."""
    if q.device.type != "cuda":
        raise ValueError(f"expected CUDA tensors, got {q.device}")
    if q.dtype not in _SUFFIX:
        raise TypeError(f"expected bfloat16 or float32, got {q.dtype}")
    q, k, v = _strided("q", q, q), _strided("k", k, q), _strided("v", v, q)
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != dh or v.shape != k.shape:
        raise ValueError(
            f"k and v must be [{B}, Sk, KV, {dh}] alike, got {tuple(k.shape)} and {tuple(v.shape)}"
        )
    if KV == 0 or H % KV:
        raise ValueError(f"n_heads {H} is not a multiple of n_kv {KV}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {dh} is not one of the built {HEAD_DIMS}")
    out = torch.empty((B, Sq, H, dh), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_int64 * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]
    )
    fn = getattr(_build.library(), f"flash_attention_{_SUFFIX[q.dtype]}")
    err = fn(
        q.device.index,
        q.data_ptr(),
        k.data_ptr(),
        v.data_ptr(),
        out.data_ptr(),
        B,
        Sq,
        Sk,
        H,
        KV,
        dh,
        strides,
        dh**-0.5,
        int(causal),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention: CUDA launch failed with cudaError {err}")
    LAUNCHES["flash_attention"] += 1
    return out
