"""Architecture registry (port of ``repro.configs``), limited to the
configurations the port carries: the dense attention stacks.  The other
architectures of the reference wait for their layers (ROADMAP A11)."""
from __future__ import annotations

import importlib

from ..models.config import ArchConfig

ARCH_IDS = ["stablelm_3b", "gemma2_27b", "qwen2p5_3b"]

# canonical ids as assigned (hyphens/dots) -> module names
ALIASES = {
    "stablelm-3b": "stablelm_3b",
    "gemma2-27b": "gemma2_27b",
    "qwen2.5-3b": "qwen2p5_3b",
}


def _module(arch: str):
    mod = ALIASES.get(arch, arch).replace("-", "_").replace(".", "p")
    if mod not in ARCH_IDS:
        raise KeyError(f"{arch}: the port carries only {ARCH_IDS}; the other "
                       f"architectures wait for their layers (ROADMAP A11)")
    return importlib.import_module(f"{__name__}.{mod}")


def get_config(arch: str) -> ArchConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ArchConfig:
    return _module(arch).SMOKE_CONFIG


def all_configs() -> dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
