"""Dense feed-forward blocks: SwiGLU (modern LMs) and GELU (whisper); the
port's ``repro/models/mlp.py``."""

from __future__ import annotations

import torch.nn.functional as F

from repro_torch.models.common import init_dense
from repro_torch.sharding import constrain

__all__ = ["init_mlp", "mlp_apply", "mlp_specs"]


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


def mlp_specs(cfg) -> dict:
    """The logical names of :func:`init_mlp`'s weights, the reference's."""
    if cfg.mlp_kind == "swiglu":
        return {"wg": ("embed", "ff"), "wu": ("embed", "ff"), "wd": ("ff", "embed")}
    return {"w1": ("embed", "ff"), "w2": ("ff", "embed")}


def mlp_apply(p, cfg, x):
    cd = cfg.compute_dtype
    if cfg.mlp_kind == "swiglu":
        g = x @ p["wg"].to(cd)
        u = x @ p["wu"].to(cd)
        h = constrain(F.silu(g) * u, "batch", None, "ff")
        return h @ p["wd"].to(cd)
    # jax.nn.gelu's default is the tanh approximation
    h = constrain(F.gelu(x @ p["w1"].to(cd), approximate="tanh"), "batch", None, "ff")
    return h @ p["w2"].to(cd)
