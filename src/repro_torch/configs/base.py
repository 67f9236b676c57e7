"""Architecture + run configuration schema (the port's copy of
``repro/configs/base.py``).

One :class:`ArchConfig` per assigned architecture (exact public dims), plus
``reduced()`` variants for CPU smoke tests.  The dtypes are torch's; the
reference's ``input_specs`` (ShapeDtypeStruct stand-ins for its multi-pod
dry-run) has no counterpart here.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any

import torch

__all__ = ["ArchConfig", "ShapeSpec", "SHAPES"]


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# The four assigned LM shapes (identical across archs; decode shapes run
# serve_step with a KV/state cache of seq_len).
SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class ArchConfig:
    # identity
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    # transformer core
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    d_head: int = 0  # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_frac: float = 1.0  # fraction of head dim rotated (chatglm3: 0.5)
    rope_theta: float = 10_000.0
    mlp_kind: str = "swiglu"  # swiglu | gelu
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_period: int = 1  # MoE at layers where l % period == offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    # hybrid / SSM
    attn_period: int = 1  # 1 -> every layer is attention; k -> one attn per k
    attn_offset: int = 0  # position of the attn layer within the period
    ssm_state: int = 0  # N; 0 disables SSD blocks
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_groups: int = 1
    # encoder-decoder (whisper)
    enc_layers: int = 0
    enc_frames: int = 1_500  # stub conv-frontend output length
    # numerics
    norm_eps: float = 1e-5
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    opt_dtype: Any = torch.float32
    tie_embeddings: bool = False
    # training-step policy
    remat: bool = True
    microbatch: int = 1  # grad-accumulation steps in train_step
    attn_chunk: int = 1_024  # blocked-attention q/kv chunk
    # blocked attention (sequences longer than attn_chunk): True runs the
    # flash-attention kernel (its plain version on the CPU), False the plain
    # torch blocked scan; in the reference, its two blocked forwards
    flash_vjp: bool = True
    moe_chunk: int = 512  # token chunk for MoE dispatch
    loss_chunk: int = 512  # sequence chunk for the vocab-sharded xent
    ssd_chunk: int = 256  # SSD intra-chunk length
    # which assigned shapes are runnable (None -> all); long_500k is skipped
    # for pure full-attention archs (quadratic prefill/cache infeasible)
    skip_shapes: tuple = ()

    # ------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def unit_size(self) -> int:
        """Length of the repeating layer pattern."""
        u = 1
        if self.attn_period > 1:
            u = math.lcm(u, self.attn_period)
        if self.n_experts and self.moe_period > 1:
            u = math.lcm(u, self.moe_period)
        return u

    @property
    def n_units(self) -> int:
        if self.n_layers % self.unit_size:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"unit={self.unit_size}"
            )
        return self.n_layers // self.unit_size

    def layer_kind(self, pos: int) -> str:
        """'attn' or 'ssd' for position ``pos`` within a unit."""
        if self.ssm_state and self.attn_period == 0:
            return "ssd"  # pure SSM
        if self.ssm_state and self.attn_period > 1:
            return "attn" if pos % self.attn_period == self.attn_offset else "ssd"
        return "attn"

    def layer_moe(self, pos: int) -> bool:
        if not self.n_experts:
            return False
        return pos % self.moe_period == self.moe_offset

    def runnable(self, shape_name: str) -> bool:
        return shape_name not in self.skip_shapes

    # ------------------------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Small same-family variant for CPU smoke tests."""
        unit = self.unit_size
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=unit * (2 if unit == 1 else 1) if unit <= 2 else unit,
            d_model=128,
            n_heads=4,
            n_kv=min(self.n_kv, 2) if self.n_kv < self.n_heads else 4,
            d_head=32,
            d_ff=0 if self.d_ff == 0 else (256 if not self.n_experts else 128),
            vocab=512,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_headdim=32 if self.ssm_state else 64,
            enc_layers=min(self.enc_layers, 2),
            enc_frames=64,
            attn_chunk=64,
            moe_chunk=32,
            loss_chunk=64,
            ssd_chunk=16,
            microbatch=1,
            param_dtype=torch.float32,
            compute_dtype=torch.float32,
        )
