"""Architecture registry of the port: ``--arch <id>`` -> ModelConfig.

Holds the configs whose families the port runs; the other architectures of
``repro.configs`` join as their families are ported (ROADMAP queue 3).
"""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.configs import llava15_7b, mamba2_130m, minigpt4_7b
from repro_torch.configs.base import AdapterConfig, ModelConfig, SSMConfig, reduced

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {
    "llava-1.5-7b": llava15_7b.config,
    "mamba2-130m": mamba2_130m.config,
    "minigpt4-7b": minigpt4_7b.config,
}


def list_archs():
    return list(_REGISTRY)


def get_config(arch: str) -> ModelConfig:
    if arch not in _REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch]()


def get_smoke_config(arch: str, **overrides) -> ModelConfig:
    return reduced(get_config(arch), **overrides)


__all__ = ["AdapterConfig", "ModelConfig", "SSMConfig", "get_config", "get_smoke_config",
           "list_archs", "reduced"]
