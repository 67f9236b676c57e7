"""Dispatch of flash attention: a CUDA tensor launches the kernel (or the
kernel raises), a CPU tensor runs the plain version in :mod:`.ref`."""

from __future__ import annotations

from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["flash_attention"]


def flash_attention(q, k, v, *, causal=True, return_lse=False):
    """q: [B,Sq,H,dh]; k,v: [B,Sk,KV,dh] -> [B,Sq,H,dh] in q's dtype; with
    ``return_lse``, ``(out, lse)``, lse [B,H,Sq] the rows' log-sum-exp in
    float32."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, return_lse=return_lse)
    return kernel.flash_attention(q, k, v, causal=causal, return_lse=return_lse)
