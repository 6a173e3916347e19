"""qwen1.5-4b — dense decoder with QKV bias.

[hf:Qwen/Qwen1.5-0.5B family scaled per assignment] 40L, d_model=2560,
20 heads (GQA kv=20 — i.e. MHA), d_ff=6912, vocab=151936, QKV bias.
"""
from repro_torch.configs.base import AdapterConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b",
        family="dense",
        n_layers=40,
        d_model=2560,
        n_heads=20,
        n_kv_heads=20,
        d_ff=6912,
        vocab_size=151936,
        max_seq_len=32768,
        pos_type="rope",
        rope_theta=1000000.0,
        qkv_bias=True,
        norm="rmsnorm",
        act="swiglu",
        adapter=AdapterConfig(rank=64, alpha=128.0, modalities=("text",)),
    )
