"""llama4-scout-17b-a16e — MoE decoder, 16 experts top-1, early fusion.

[hf:meta-llama/Llama-4-Scout-17B-16E] 48L, d_model=5120, 40 heads (GQA kv=8),
d_ff=8192 per expert, vocab=202048, MoE 16e top-1 with a shared expert
(llama4 routes top-1 + always-on shared FFN).
"""
from repro_torch.configs.base import AdapterConfig, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=202048,
        max_seq_len=32768,
        pos_type="rope",
        rope_theta=500000.0,
        norm="rmsnorm",
        act="swiglu",
        moe=MoEConfig(n_experts=16, top_k=1, capacity_factor=1.25, shared_d_ff=8192),
        adapter=AdapterConfig(rank=64, alpha=128.0, modalities=("text",)),
    )
