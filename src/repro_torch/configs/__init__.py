"""Architecture registry of the port: --arch <id> -> ModelConfig, for every
architecture of the JAX package."""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig  # noqa: F401

_MODULES: Dict[str, str] = {
    "llama3.2-3b": "llama3_2_3b",
    "rwkv6-3b": "rwkv6_3b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "hymba-1.5b": "hymba_1_5b",
    "qwen1.5-110b": "qwen1_5_110b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "paligemma-3b": "paligemma_3b",
    "nemotron-4-340b": "nemotron_4_340b",
}


def list_archs() -> List[str]:
    return sorted(_MODULES)


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise ValueError(f"unknown arch {arch_id!r}; options: {list_archs()}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()
