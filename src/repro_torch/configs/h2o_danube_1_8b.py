"""h2o-danube-1.8b — dense decoder, llama+mistral mix with sliding-window attention.

[arXiv:2401.16818] 24L, d_model=2560, 32 heads (GQA kv=8), d_ff=6912,
vocab=32000, SWA window 4096 (mistral-style).
"""
from repro_torch.configs.base import AdapterConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b",
        family="dense",
        n_layers=24,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        d_ff=6912,
        vocab_size=32000,
        max_seq_len=16384,
        pos_type="rope",
        rope_theta=10000.0,
        sliding_window=4096,
        norm="rmsnorm",
        act="swiglu",
        adapter=AdapterConfig(rank=64, alpha=128.0, modalities=("text",)),
    )
