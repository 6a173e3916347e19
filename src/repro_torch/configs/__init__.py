"""Architecture registry of the port: ``--arch <id>`` -> ModelConfig.

Holds every config of ``repro.configs``: the paper's two MLLM backbones and
qwen2-vl-72b with M-RoPE (vlm), mamba2-130m (ssm), the dense family's four
(h2o-danube-1.8b with its sliding window, glm4-9b and qwen1.5-4b with their
QKV bias, internlm2-20b), the MoE family's two (llama4-scout-17b-a16e, top-1
with a shared expert; grok-1-314b, top-2 with GELU experts and capped
attention logits), recurrentgemma-9b (hybrid: RG-LRU and local attention,
GeGLU) and whisper-base (audio: encoder-decoder, LayerNorm, learned
positions).
"""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.configs import (
    glm4_9b,
    grok_1_314b,
    h2o_danube_1_8b,
    internlm2_20b,
    llama4_scout_17b_a16e,
    llava15_7b,
    mamba2_130m,
    minigpt4_7b,
    qwen1_5_4b,
    qwen2_vl_72b,
    recurrentgemma_9b,
    whisper_base,
)
from repro_torch.configs.base import (INPUT_SHAPES, AdapterConfig, InputShape, ModelConfig,
                                      MoEConfig, RGLRUConfig, SSMConfig, reduced)

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {
    "glm4-9b": glm4_9b.config,
    "grok-1-314b": grok_1_314b.config,
    "h2o-danube-1.8b": h2o_danube_1_8b.config,
    "internlm2-20b": internlm2_20b.config,
    "llama4-scout-17b-a16e": llama4_scout_17b_a16e.config,
    "llava-1.5-7b": llava15_7b.config,
    "mamba2-130m": mamba2_130m.config,
    "minigpt4-7b": minigpt4_7b.config,
    "qwen1.5-4b": qwen1_5_4b.config,
    "qwen2-vl-72b": qwen2_vl_72b.config,
    "recurrentgemma-9b": recurrentgemma_9b.config,
    "whisper-base": whisper_base.config,
}


# the ten assigned architectures, in the JAX registry's order, and the
# paper's own two MLLM backbones (``repro/configs/__init__.py:55-68``)
ASSIGNED_ARCHS = [
    "h2o-danube-1.8b",
    "qwen1.5-4b",
    "llama4-scout-17b-a16e",
    "recurrentgemma-9b",
    "qwen2-vl-72b",
    "grok-1-314b",
    "mamba2-130m",
    "glm4-9b",
    "whisper-base",
    "internlm2-20b",
]

PAPER_ARCHS = ["llava-1.5-7b", "minigpt4-7b"]


def list_archs():
    return list(_REGISTRY)


def get_config(arch: str) -> ModelConfig:
    if arch not in _REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch]()


def get_smoke_config(arch: str, **overrides) -> ModelConfig:
    return reduced(get_config(arch), **overrides)


__all__ = ["ASSIGNED_ARCHS", "INPUT_SHAPES", "PAPER_ARCHS", "AdapterConfig", "InputShape",
           "ModelConfig", "MoEConfig", "RGLRUConfig", "SSMConfig", "get_config",
           "get_smoke_config", "list_archs", "reduced"]
