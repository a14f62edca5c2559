"""Registry mapping --arch ids to configs (one module per assigned arch)."""
from __future__ import annotations

import importlib
from typing import Dict, List

from .base import ArchConfig, SHAPES, ShapeConfig

ARCH_IDS: List[str] = [
    "phi3_vision_4p2b",
    "mistral_large_123b",
    "llama3p2_1b",
    "starcoder2_7b",
    "internlm2_1p8b",
    "llama4_maverick_400b_a17b",
    "qwen3_moe_30b_a3b",
    "mamba2_780m",
    "recurrentgemma_9b",
    "musicgen_large",
]

# accept the assignment-sheet spellings too
ALIASES = {
    "phi-3-vision-4.2b": "phi3_vision_4p2b",
    "mistral-large-123b": "mistral_large_123b",
    "llama3.2-1b": "llama3p2_1b",
    "starcoder2-7b": "starcoder2_7b",
    "internlm2-1.8b": "internlm2_1p8b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "mamba2-780m": "mamba2_780m",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "musicgen-large": "musicgen_large",
}


def get_arch(name: str) -> ArchConfig:
    name = ALIASES.get(name, name)
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f".{name}", __package__)
    return mod.CONFIG


def all_archs() -> Dict[str, ArchConfig]:
    return {a: get_arch(a) for a in ARCH_IDS}


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]
