"""grok-1-314b — MoE decoder, 8 experts top-2.

[hf:xai-org/grok-1] 64L, d_model=6144, 48 heads (GQA kv=8), d_ff=32768 per
expert, vocab=131072, MoE 8e top-2, attention-logit softcap 30 (grok uses
tanh soft-capping on attention logits).

The flagship server-centralization case for FedNano: 314B params (~628 GB
bf16) can never be deployed client-side; with FedNano the clients hold only
NanoEdge (<5%) and upload rank-64 adapters (~0.01%).
"""
from repro_torch.configs.base import AdapterConfig, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b",
        family="moe",
        n_layers=64,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=32768,
        vocab_size=131072,
        max_seq_len=8192,
        pos_type="rope",
        rope_theta=10000.0,
        logit_softcap=30.0,
        norm="rmsnorm",
        act="gelu",
        moe=MoEConfig(n_experts=8, top_k=2, capacity_factor=1.25),
        adapter=AdapterConfig(rank=64, alpha=128.0, modalities=("text",)),
    )
