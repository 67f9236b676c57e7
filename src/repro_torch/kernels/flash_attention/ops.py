"""Dispatch of flash attention: a CUDA tensor launches the kernel (or the
kernel raises), a CPU tensor runs the plain version in :mod:`.ref`.

Both entries are ``torch.library`` custom ops, ``repro_torch::flash_attention``
and ``repro_torch::flash_attention_lse``, so that a dispatch mode sees one
op where the kernel launches (``repro_torch.analysis.flops`` counts it by
:func:`flops`) and a ``meta`` tensor takes the ops' fake implementations
(shapes only), which is how the dry run traces a step that launches the
kernel without a card.  The CUDA path is the kernel's wrapper as it was:
the same launch, the same bits.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["flash_attention", "flops"]


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> torch.Tensor:
    if q.device.type == "cpu":  # contiguous, as the kernel writes it
        return attention_ref(q, k, v, causal=causal).contiguous()
    return kernel.flash_attention(q, k, v, causal=causal)


@torch.library.custom_op("repro_torch::flash_attention_lse", mutates_args=())
def _flash_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    if q.device.type == "cpu":
        out, lse = attention_ref(q, k, v, causal=causal, return_lse=True)
        return out.contiguous(), lse
    return kernel.flash_attention(q, k, v, causal=causal, return_lse=True)


@_flash.register_fake
def _(q, k, v, causal):
    return q.new_empty(q.shape)


@_flash_lse.register_fake
def _(q, k, v, causal):
    B, Sq, H, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((B, H, Sq), dtype=torch.float32)


def flash_attention(q, k, v, *, causal=True, return_lse=False):
    """q: [B,Sq,H,dh]; k,v: [B,Sk,KV,dh] -> [B,Sq,H,dh] in q's dtype; with
    ``return_lse``, ``(out, lse)``, lse [B,H,Sq] the rows' log-sum-exp in
    float32."""
    if return_lse:
        return torch.ops.repro_torch.flash_attention_lse(q, k, v, causal)
    return torch.ops.repro_torch.flash_attention(q, k, v, causal)


def _visible_pairs(sq: int, sk: int, causal: bool) -> int:
    """The (query, key) pairs one head of one sequence attends: every pair,
    or under the causal mask (row i sees keys j <= i + sk - sq) the
    triangle, sq (sq + 1) / 2 at sq == sk."""
    if not causal:
        return sq * sk
    off = sk - sq
    return sq * (sq + 1) // 2 + off * sq if off >= 0 else sk * (sk + 1) // 2


def flops(q_shape, k_shape, causal: bool) -> int:
    """The operations of one launch: QK^T and PV over the visible pairs,
    2 * dh each, 4 * B * H * dh * pairs (``PERF.md`` row 10's count, which
    at B = 4, H = 32, dh = 128, Sq = Sk = 2,048 causal is 1.375e11)."""
    B, sq, H, dh = q_shape
    return 4 * B * H * dh * _visible_pairs(sq, k_shape[1], causal)
