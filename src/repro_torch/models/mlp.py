"""Dense feed-forward blocks: SwiGLU (modern LMs) and GELU (whisper); the
port's ``repro/models/mlp.py``."""

from __future__ import annotations

import torch.nn.functional as F

from repro_torch.models.common import init_dense

__all__ = ["init_mlp", "mlp_apply"]


def init_mlp(generator, cfg, device=None) -> dict:
    D, FF = cfg.d_model, cfg.d_ff
    dt = cfg.param_dtype
    if cfg.mlp_kind == "swiglu":
        return {
            "wg": init_dense(generator, D, FF, dt, device),
            "wu": init_dense(generator, D, FF, dt, device),
            "wd": init_dense(generator, FF, D, dt, device, scale=FF**-0.5),
        }
    return {  # gelu
        "w1": init_dense(generator, D, FF, dt, device),
        "w2": init_dense(generator, FF, D, dt, device, scale=FF**-0.5),
    }


def mlp_apply(p, cfg, x):
    cd = cfg.compute_dtype
    if cfg.mlp_kind == "swiglu":
        g = x @ p["wg"].to(cd)
        u = x @ p["wu"].to(cd)
        return (F.silu(g) * u) @ p["wd"].to(cd)
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x @ p["w1"].to(cd), approximate="tanh") @ p["w2"].to(cd)
