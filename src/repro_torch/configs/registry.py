"""Architecture registry: ``--arch <id>`` resolution for every launcher."""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.chameleon_34b import CONFIG as chameleon_34b
from repro_torch.configs.chatglm3_6b import CONFIG as chatglm3_6b
from repro_torch.configs.grok_1_314b import CONFIG as grok_1_314b
from repro_torch.configs.jamba_v0_1_52b import CONFIG as jamba_v0_1_52b
from repro_torch.configs.mamba2_1_3b import CONFIG as mamba2_1_3b
from repro_torch.configs.olmoe_1b_7b import CONFIG as olmoe_1b_7b
from repro_torch.configs.qwen3_32b import CONFIG as qwen3_32b
from repro_torch.configs.qwen3_4b import CONFIG as qwen3_4b
from repro_torch.configs.stablelm_12b import CONFIG as stablelm_12b
from repro_torch.configs.whisper_tiny import CONFIG as whisper_tiny

__all__ = ["ARCHS", "get_arch", "list_archs"]

ARCHS: dict[str, ArchConfig] = {
    c.name: c
    for c in (
        jamba_v0_1_52b,
        chameleon_34b,
        qwen3_4b,
        qwen3_32b,
        chatglm3_6b,
        stablelm_12b,
        grok_1_314b,
        olmoe_1b_7b,
        mamba2_1_3b,
        whisper_tiny,
    )
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs() -> list[str]:
    return list(ARCHS)
