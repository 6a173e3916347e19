"""internlm2-20b — dense decoder, GQA.

[arXiv:2403.17297] 48L, d_model=6144, 48 heads (GQA kv=8), d_ff=16384,
vocab=92544, RoPE theta 1e6 (long-context variant).
"""
from repro_torch.configs.base import AdapterConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b",
        family="dense",
        n_layers=48,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=16384,
        vocab_size=92544,
        max_seq_len=32768,
        pos_type="rope",
        rope_theta=1000000.0,
        norm="rmsnorm",
        act="swiglu",
        adapter=AdapterConfig(rank=64, alpha=128.0, modalities=("text",)),
    )
