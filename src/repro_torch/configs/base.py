"""Configuration dataclasses of the PyTorch port.

The port's own copy of ``repro.configs.base``, cut to what the ported
families (``dense`` / ``vlm``) read. The field names and defaults are the
JAX package's, so ``tests/test_torch_model.py`` can hold the two smoke
configs against each other field by field. The switches only other families
set (sliding window, softcap, QKV bias, tied embeddings, sequence limit) and
the sub-family configs (MoE, SSM, RG-LRU, encoder-decoder) arrive with those
families (ROADMAP queue 1).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Tuple


@dataclass(frozen=True)
class AdapterConfig:
    """NanoEdge / NanoAdapter configuration (the paper's contribution)."""

    rank: int = 64
    alpha: float = 128.0
    modalities: Tuple[str, ...] = ("text",)  # ("text",), or ("text", "image")
    dtype: str = "float32"   # adapters are stored in f32, the backbone runs bf16


@dataclass(frozen=True)
class ModelConfig:
    name: str = "unnamed"
    family: str = "dense"          # the port runs dense | vlm
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0              # 0 -> d_model // n_heads
    d_ff: int = 512
    vocab_size: int = 1024

    # positions / block structure
    pos_type: str = "rope"         # the port runs rope
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"          # the port runs rmsnorm
    act: str = "swiglu"            # the port runs swiglu

    # modality frontend stub (vlm): incoming embedding width before connector
    frontend_dim: int = 0

    # NanoEdge
    adapter: AdapterConfig = field(default_factory=AdapterConfig)

    # numerics / execution
    dtype: str = "bfloat16"
    use_pallas: bool = False       # route hot ops through the hand-written kernels

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Smoke-test variant of the same family: <=2 layers, d_model <= 256.

    Keeps every structural switch identical so the smoke test exercises the
    same code path as the full config (``repro.configs.base.reduced``).
    """
    d_model = min(cfg.d_model, 256)
    n_heads = min(cfg.n_heads, 4)
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    if cfg.n_kv_heads < cfg.n_heads:
        n_kv = max(1, n_heads // max(1, cfg.q_per_kv))
    kw = dict(
        n_layers=min(cfg.n_layers, 2),
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=d_model // n_heads,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        dtype="float32",
        adapter=dataclasses.replace(cfg.adapter, rank=4, alpha=8.0),
    )
    if cfg.frontend_dim:
        kw["frontend_dim"] = min(cfg.frontend_dim, 128)
    kw.update(overrides)
    return replace(cfg, **kw)
