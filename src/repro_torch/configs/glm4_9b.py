"""glm4-9b — dense decoder, RoPE + GQA kv=2.

[hf:THUDM/glm-4-9b] 40L, d_model=4096, 32 heads (GQA kv=2), d_ff=13696,
vocab=151552. GLM uses partial rotary (applied to half the head dim) and
QKV bias on glm-4; we model the QKV bias and standard full RoPE (partial
rotary is a numerics detail orthogonal to the systems contribution).
"""
from repro_torch.configs.base import AdapterConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b",
        family="dense",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=2,
        d_ff=13696,
        vocab_size=151552,
        max_seq_len=131072,
        pos_type="rope",
        rope_theta=10000.0,
        qkv_bias=True,
        norm="rmsnorm",
        act="swiglu",
        adapter=AdapterConfig(rank=64, alpha=128.0, modalities=("text",)),
    )
