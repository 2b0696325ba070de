"""Architecture registry (port of ``repro.configs``): the reference's ten
configurations, one module each."""
from __future__ import annotations

import importlib

from ..models.config import ArchConfig

ARCH_IDS = [
    "mamba2_1p3b", "mixtral_8x22b", "olmoe_1b_7b", "stablelm_3b",
    "gemma2_27b", "gemma3_12b", "qwen2p5_3b", "pixtral_12b",
    "seamless_m4t_medium", "jamba_v0p1_52b",
]

# canonical ids as assigned (hyphens/dots) -> module names
ALIASES = {
    "mamba2-1.3b": "mamba2_1p3b",
    "mixtral-8x22b": "mixtral_8x22b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "stablelm-3b": "stablelm_3b",
    "gemma2-27b": "gemma2_27b",
    "gemma3-12b": "gemma3_12b",
    "qwen2.5-3b": "qwen2p5_3b",
    "pixtral-12b": "pixtral_12b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "jamba-v0.1-52b": "jamba_v0p1_52b",
}


def _module(arch: str):
    mod = ALIASES.get(arch, arch).replace("-", "_").replace(".", "p")
    if mod not in ARCH_IDS:
        raise KeyError(f"{arch}: not one of {ARCH_IDS}")
    return importlib.import_module(f"{__name__}.{mod}")


def get_config(arch: str) -> ArchConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ArchConfig:
    return _module(arch).SMOKE_CONFIG


def all_configs() -> dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
