"""Configuration dataclasses of the PyTorch port.

The port's own copy of ``repro.configs.base``, cut to what the six families
(``dense`` / ``vlm`` / ``moe`` / ``ssm`` / ``hybrid`` / ``audio``) read.
The field names, defaults and order are the JAX package's, so
``tests/test_torch_model.py`` can hold the configs against each other field
by field.

The port has the JAX fields that its configs set and its code reads: the
dense family's ``qkv_bias`` and ``sliding_window``, qwen2-vl's
``mrope_sections``, the MoE family's ``moe`` and ``logit_softcap`` (grok-1
caps its attention logits), the hybrid family's ``rglru``, and the
encoder-decoder family's ``max_seq_len`` (the learned position table),
``n_enc_layers`` and ``enc_seq_len``. ``parallel_block`` is set by no
config and read by no layer of the JAX package, and the adapters'
``dropout`` is read nowhere in it. ``attn_chunk`` and ``loss_chunk``
bound the plain path's live logits at long sequences (the launch layer's
``exec_config`` sets ``attn_chunk``; ``loss_chunk`` comes with a dry-run
``--override``). ``remat`` (on by default, off in ``reduced``, as in the
JAX package) checkpoints each layer body in training: the forward keeps only
each layer's input, and the backward runs the body's forward once more
(``models/transformer.py``, ``models/encdec.py``); it changes memory and
time, not the loss or the gradients. The JAX package's other execution
switches for its TPU mesh (``scan_layers``, ``seq_parallel``,
``ctx_parallel_attn``) have no counterpart here. ``InputShape`` describes a
workload, ``INPUT_SHAPES`` the four production shapes
(``repro/configs/base.py:194-199``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01  # balance-loss weight; the backbone is frozen, so reported only
    shared_d_ff: int = 0  # llama4-style shared expert FFN width (0 = none)


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD: state space duality, arXiv:2405.21060)."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64       # SSD multi-head: d_inner / head_dim heads
    chunk_size: int = 256    # chunked-scan block length; fixes the f32 summation order
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclass(frozen=True)
class RGLRUConfig:
    """RG-LRU recurrent block (Griffin/RecurrentGemma, arXiv:2402.19427)."""

    d_rnn: int = 0            # recurrence width (0 -> d_model)
    conv_width: int = 4
    block_pattern: Tuple[str, ...] = ("rec", "rec", "attn")  # 1:2 attn:recurrent
    local_window: int = 2048  # local-attention window of the attn layers


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
    family: str = "dense"          # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0              # 0 -> d_model // n_heads
    d_ff: int = 512
    vocab_size: int = 1024
    max_seq_len: int = 8192        # rows of the learned position table

    # attention / positions
    pos_type: str = "rope"         # rope | mrope | learned | none
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE (t, h, w) frequency slots
    qkv_bias: bool = False
    sliding_window: Optional[int] = None   # SWA window (h2o-danube: 4096)
    logit_softcap: float = 0.0             # grok-style tanh cap on attention logits (0 = off)

    # block structure
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    act: str = "swiglu"            # swiglu | geglu | gelu
    tie_embeddings: bool = False   # logits read the embedding table (no unembed)

    # sub-family configs
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None

    # encoder-decoder (audio family, whisper-style)
    n_enc_layers: int = 0
    enc_seq_len: int = 1500        # fixed encoder memory length (frames)

    # modality frontend stub (vlm/audio): incoming embedding width before connector
    frontend_dim: int = 0

    # NanoEdge
    adapter: AdapterConfig = field(default_factory=AdapterConfig)

    # numerics / execution
    dtype: str = "bfloat16"
    remat: bool = True             # checkpoint each layer body in training
    use_pallas: bool = False       # route hot ops through the hand-written kernels
    attn_chunk: Optional[int] = None   # query chunking of the plain attention path;
                                       # bounds live logits to (B, H, chunk, S)
    loss_chunk: Optional[int] = None   # chunked cross-entropy (bounds (B, chunk, V) logits)

    @property
    def subquadratic(self) -> bool:
        """Sub-quadratic sequence mixing: decides ``long_500k`` eligibility."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window is not None

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Smoke-test variant of the same family: <=2 layers (a hybrid stack 3, one
    (rec, rec, attn) triple), d_model <= 256, <=4 experts.

    Keeps every structural switch identical so the smoke test exercises the
    same code path as the full config (``repro.configs.base.reduced``).
    """
    d_model = min(cfg.d_model, 256)
    n_heads = min(cfg.n_heads, 4)
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    if cfg.n_kv_heads < cfg.n_heads:
        n_kv = max(1, n_heads // max(1, cfg.q_per_kv))
    head_dim = d_model // n_heads
    kw = dict(
        n_layers=min(cfg.n_layers, 2),
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        max_seq_len=min(cfg.max_seq_len, 512),
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else None,
        mrope_sections=(head_dim // 4, head_dim // 8, head_dim // 8) if cfg.mrope_sections else (),
        dtype="float32",
        remat=False,
        adapter=dataclasses.replace(cfg.adapter, rank=4, alpha=8.0),
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=min(cfg.moe.n_experts, 4), top_k=min(cfg.moe.top_k, 2),
            shared_d_ff=min(cfg.moe.shared_d_ff, 256) if cfg.moe.shared_d_ff else 0,
        )
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=32, chunk_size=32)
    if cfg.rglru is not None:
        kw["rglru"] = dataclasses.replace(
            cfg.rglru, d_rnn=0, local_window=min(cfg.rglru.local_window, 64))
        kw["n_layers"] = 3  # one full (rec, rec, attn) block
    if cfg.n_enc_layers:
        kw["n_enc_layers"] = min(cfg.n_enc_layers, 2)
        kw["enc_seq_len"] = min(cfg.enc_seq_len, 64)
    if cfg.frontend_dim:
        kw["frontend_dim"] = min(cfg.frontend_dim, 128)
    kw.update(overrides)
    return replace(cfg, **kw)


@dataclass(frozen=True)
class InputShape:
    """A workload: (kind, seq_len, global_batch)."""

    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", "train", 4_096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32_768, 128),
    "long_500k": InputShape("long_500k", "decode", 524_288, 1),
}
