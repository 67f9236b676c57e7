"""Dispatch of flash attention: a CUDA tensor launches the kernel (or the
kernel raises), a CPU tensor runs the plain version in :mod:`.ref`."""

from __future__ import annotations

from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["flash_attention"]


def flash_attention(q, k, v, *, causal=True):
    """q: [B,Sq,H,dh]; k,v: [B,Sk,KV,dh] -> [B,Sq,H,dh] in q's dtype."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal)
    return kernel.flash_attention(q, k, v, causal=causal)
