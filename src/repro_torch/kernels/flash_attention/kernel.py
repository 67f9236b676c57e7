"""ctypes wrapper of the CUDA flash-attention kernels
(``csrc/flash_attention_hopper.cu``, ``csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention/kernel.py:flash_attention``
(Pallas, TPU).  The sources' header comments give the designs and what
bounds them.  Three kernels compute the same function; :func:`variant` picks
one from the inputs' dtype, head dim, strides and alignment alone, before
any launch:

- ``"wgmma"``: the Hopper kernel (TMA loads, wgmma products, warp
  specialisation), bfloat16 at every built head dim (32, 64, 128, 160), when
  q, k and v can be described by TMA tensor maps in place;
- ``"mma"``: the mma.sync kernel, bfloat16 inputs no tensor map can read (a
  strided head dim, strides or base not in 16-byte steps, heads outside
  sequence, no keys);
- ``"f32"``: the float32 kernel (register-tiled SIMT, no tensor cores).

With ``return_lse=True`` the same kernel also writes each row's
log-sum-exp ``lse`` ``[B, H, Sq]`` in float32 (the residual a backward
recomputes the probabilities from, as the reference's
``models/flash_vjp.py`` defines it); ``out`` is the same either way.

The wrapper checks its inputs, allocates the outputs with ``torch.empty``,
launches on the current stream, raises on a non-zero error code (a failed
launch is never retried on another variant), and counts the launches of each
variant in :data:`LAUNCHES`, those that write ``lse`` under the variant's
name with ``_lse`` appended.

Inputs are read in place through their strides (batch, sequence, head; the
head dimension must be contiguous), so GQA reads K/V head ``h // (H / KV)``
without repeating it.  For the mma.sync and float32 kernels, a tensor whose
head dimension is strided, whose other strides are not whole 16-byte steps,
or whose data is not 16-byte aligned is first copied with
``clone(memory_format=torch.contiguous_format)``; the model's q/k/v never
are.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["HEAD_DIMS", "LAUNCHES", "WGMMA_HEAD_DIMS", "flash_attention", "variant"]

LAUNCHES = {
    f"flash_attention_{kind}{suffix}": 0
    for suffix in ("", "_lse") for kind in ("wgmma", "mma", "f32")
}

# the head dims ``dispatch_head_dim`` in csrc/flash_attention.cu builds kernels for
HEAD_DIMS = (32, 64, 128, 160)
# the head dims csrc/flash_attention_hopper.cu builds its kernel for
WGMMA_HEAD_DIMS = (32, 64, 128, 160)
_DTYPES = (torch.bfloat16, torch.float32)


def _aligned(t: torch.Tensor) -> bool:
    """Head dim contiguous, the other strides whole 16-byte steps, the data
    16-byte aligned: what every kernel reads in place."""
    per_16b = 16 // t.element_size()
    return (
        t.stride(3) == 1
        and all(s % per_16b == 0 for s in t.stride()[:3])
        and t.data_ptr() % 16 == 0
    )


def _nested_strides(t: torch.Tensor) -> tuple[int, int, int] | None:
    """(batch, sequence, head) strides in elements for a tensor map over
    (head dim, heads, sequence, batch), or None if the dimensions do not nest
    in that order (each stride covers the dimension inside it).  A dimension
    of size 1 is never stepped, so it takes the nested stride."""
    _, S, n, dh = t.shape
    s_b, s_s, s_h = t.stride()[:3]
    s_h = s_h if n > 1 else dh
    s_s = s_s if S > 1 else n * s_h
    s_b = s_b if t.shape[0] > 1 else S * s_s
    if s_h < dh or s_s < n * s_h or s_b < S * s_s:
        return None
    return s_b, s_s, s_h


def variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel that computes attention of these inputs: ``"wgmma"``,
    ``"mma"`` or ``"f32"`` (see the module's doc).  A pure function of the
    dtype, the shapes, the strides and the data's alignment; it launches
    nothing and takes tensors on any device."""
    if q.dtype == torch.float32:
        return "f32"
    if (
        q.shape[3] in WGMMA_HEAD_DIMS
        and k.shape[1] > 0
        and all(_aligned(t) and _nested_strides(t) is not None for t in (q, k, v))
    ):
        return "wgmma"
    return "mma"


def _checked(name: str, t: torch.Tensor, like: torch.Tensor, copy: bool) -> torch.Tensor:
    if t.device != like.device or t.dtype != like.dtype:
        raise ValueError(f"{name} must be {like.dtype} on {like.device}, got {t.dtype} on {t.device}")
    if t.ndim != 4:
        raise ValueError(f"{name} must be [B, S, heads, head_dim], got {tuple(t.shape)}")
    if not copy or _aligned(t):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _launch(q, k, v, causal: bool, kind: str | None, return_lse: bool = False):
    if q.device.type != "cuda":
        raise ValueError(f"expected CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"expected bfloat16 or float32, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _checked(name, t, q, copy=False)
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
    kind = kind or variant(q, k, v)
    if kind == "wgmma":  # read in place, a size-1 dimension with its nested stride
        in_strides = [_nested_strides(t) for t in (q, k, v)]
    else:
        q, k, v = (_checked(name, t, q, copy=True) for name, t in (("q", q), ("k", k), ("v", v)))
        in_strides = [t.stride()[:3] for t in (q, k, v)]
    out = torch.empty((B, Sq, H, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if return_lse else None
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    strides = (ctypes.c_int64 * 12)(*in_strides[0], *in_strides[1], *in_strides[2],
                                    *out.stride()[:3])
    fn = getattr(_build.library(), f"flash_attention_{kind}")
    err = fn(
        q.device.index,
        q.data_ptr(),
        k.data_ptr(),
        v.data_ptr(),
        out.data_ptr(),
        None if lse is None else lse.data_ptr(),
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
    if err < 0:
        raise RuntimeError(
            f"flash_attention_{kind}: cuTensorMapEncodeTiled failed with CUresult {-err}"
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_{kind}: CUDA launch failed with cudaError {err}")
    LAUNCHES[f"flash_attention_{kind}" + ("_lse" if return_lse else "")] += 1
    return (out, lse) if return_lse else out


def flash_attention(q, k, v, *, causal=True, return_lse=False):
    """q: [B,Sq,H,dh]; k,v: [B,Sk,KV,dh] (H % KV == 0) -> [B,Sq,H,dh] in
    q's dtype (bfloat16 or float32), through the kernel :func:`variant`
    picks; with ``return_lse``, ``(out, lse)``, lse ``[B, H, Sq]`` in
    float32."""
    return _launch(q, k, v, causal, None, return_lse)


def _flash_attention_mma(q, k, v, *, causal=True, return_lse=False):
    """The mma.sync bfloat16 kernel whatever the head dim and strides, so
    that it can be held against the plain version and timed beside the
    Hopper kernel at the same shapes."""
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the mma.sync kernel takes bfloat16, got {q.dtype}")
    return _launch(q, k, v, causal, "mma", return_lse)
