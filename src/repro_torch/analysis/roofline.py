"""Roofline terms of a traced step on an NVIDIA H100 (the port's
``repro/analysis/roofline.py``).

Hardware model: one NVIDIA H100 SXM (the card ``chip_smoke.py`` runs on,
"NVIDIA H100 80GB HBM3"), from NVIDIA's H100 SXM datasheet, dense rates at
the full 700 W power limit:

- ``PEAK_FLOPS``: 989.4 TFLOP/s bf16 on the tensor cores (the rate every
  bound of ``PERF.md`` §6 uses);
- ``HBM_BW``: 3.35 TB/s of HBM3;
- ``LINK_BW``: 450 GB/s, NVLink 4 one way (900 GB/s both ways over its 18
  links), the collective term's rate.

Per (arch x shape x mesh) cell, from one rank's traced program:
    compute term    = FLOPs per rank / PEAK_FLOPS
    memory term     = bytes per rank / HBM_BW
    collective term = collective bytes per rank / LINK_BW
(seconds; the largest is the bottleneck).  The FLOPs and bytes come from
:mod:`repro_torch.analysis.flops` (the ops of one traced call), the
collective bytes from :mod:`repro_torch.analysis.hlo`.  NVLink joins the
eight cards of one host; a 256- or 512-rank mesh spans hosts, whose links
(InfiniBand, about 50 GB/s a card) are slower, so on those meshes the
collective term is a lower bound on the collective time.

``model_flops`` is 6 N D for training (N the active parameters, D the
tokens), 2 N D for a prefill and 2 N B plus the KV readout for one decode
step, the reference's; ``useful_ratio`` = model FLOPs / (FLOPs per rank x
ranks) exposes recomputation and redundancy.  :func:`model_flops_utilization`
turns a measured wall time into the share of the compute bound a step
reached.  ``param_counts`` and ``model_flops`` are analytic and give the
reference's numbers.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["HW", "RooflineTerms", "model_flops", "model_flops_utilization", "param_counts",
           "roofline_terms"]

PEAK_FLOPS = 989.4e12  # bf16 dense, tensor cores
HBM_BW = 3.35e12  # bytes/s
LINK_BW = 450e9  # bytes/s, NVLink 4, one way

HW = {"peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW, "link_bw": LINK_BW}


def param_counts(cfg) -> dict:
    """Total and active parameter counts from the config (analytic)."""
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab
    H, KV, dh = cfg.n_heads, cfg.n_kv, cfg.head_dim
    attn = D * H * dh + 2 * D * KV * dh + H * dh * D
    ffn_dense = (3 if cfg.mlp_kind == "swiglu" else 2) * D * F
    moe_total = cfg.n_experts * ffn_dense + D * cfg.n_experts
    moe_active = cfg.top_k * ffn_dense + D * cfg.n_experts

    if cfg.ssm_state:
        d_inner = cfg.ssm_expand * D
        Hs = d_inner // cfg.ssm_headdim
        GN = cfg.ssm_groups * cfg.ssm_state
        ssd = (
            D * (2 * d_inner + 2 * GN + Hs)
            + cfg.ssm_conv * (d_inner + 2 * GN)
            + d_inner * D
            + 3 * Hs
            + d_inner
        )
    else:
        ssd = 0

    total = active = 0
    for layer in range(cfg.n_layers):
        pos = layer % max(cfg.unit_size, 1)
        mix = attn if cfg.layer_kind(pos) == "attn" else ssd
        if cfg.layer_moe(pos):
            total += mix + moe_total
            active += mix + moe_active
        elif F > 0:
            total += mix + ffn_dense
            active += mix + ffn_dense
        else:
            total += mix
            active += mix
    total += cfg.enc_layers * (attn + ffn_dense)
    active += cfg.enc_layers * (attn + ffn_dense)
    emb = V * D * (1 if cfg.tie_embeddings else 2)
    return {"total": total + emb, "active": active + emb,
            "n_layers": cfg.n_layers + cfg.enc_layers}


def model_flops(cfg, shape) -> float:
    """6*N_active*tokens for training; 2*N_active*tokens for prefill;
    2*N_active*batch for one decode step (+ attention KV readout FLOPs).
    ``shape``: anything with ``kind``, ``global_batch`` and ``seq_len``."""
    n_active = param_counts(cfg)["active"]
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens
    n_attn = sum(1 for layer in range(cfg.n_layers)
                 if cfg.layer_kind(layer % max(cfg.unit_size, 1)) == "attn")
    kv_read = 4.0 * n_attn * cfg.n_heads * cfg.head_dim * shape.seq_len * shape.global_batch
    return 2.0 * n_active * shape.global_batch + kv_read


def model_flops_utilization(cfg, shape, wall_s: float, *, n_devices: int = 1) -> float:
    """Model FLOPs over the wall time over the peak: the share of
    ``n_devices`` cards' bf16 compute bound that a step of ``shape`` taking
    ``wall_s`` seconds reached."""
    return model_flops(cfg, shape) / wall_s / (PEAK_FLOPS * n_devices)


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float
    hlo_flops_per_chip: float  # the counted FLOPs of one rank's program
    useful_ratio: float  # MODEL_FLOPS / (FLOPs per rank * ranks)


def roofline_terms(
    cfg, shape, *, n_devices: int, hlo_flops: float, hlo_bytes: float,
    collective_bytes: float,
) -> RooflineTerms:
    """All inputs are one rank's (the reference's names: ``hlo_flops`` and
    ``hlo_bytes`` are the FLOPs and bytes :mod:`.flops` counts)."""
    terms = {
        "compute": hlo_flops / PEAK_FLOPS,
        "memory": hlo_bytes / HBM_BW,
        "collective": collective_bytes / LINK_BW,
    }
    mf = model_flops(cfg, shape)
    total = hlo_flops * n_devices
    return RooflineTerms(
        compute_s=terms["compute"],
        memory_s=terms["memory"],
        collective_s=terms["collective"],
        bottleneck=max(terms, key=terms.get),
        model_flops=mf,
        hlo_flops_per_chip=hlo_flops,
        useful_ratio=mf / total if total else 0.0,
    )
