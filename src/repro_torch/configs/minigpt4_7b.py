"""minigpt4-7b — the paper's second backbone (MiniGPT-4 on Vicuna-7B).

[Zhu et al. 2023] Vicuna-7B LLM (32L, d_model=4096, MHA, d_ff=11008,
vocab=32000) + EVA-CLIP ViT-G/14 + Q-Former frontend (stubbed; Q-Former
emits 32 query embeddings of width 768) + linear connector.
"""
from repro_torch.configs.base import AdapterConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minigpt4-7b",
        family="vlm",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,
        d_ff=11008,
        vocab_size=32000,
        max_seq_len=4096,
        pos_type="rope",
        rope_theta=10000.0,
        norm="rmsnorm",
        act="swiglu",
        frontend_dim=768,
        adapter=AdapterConfig(rank=64, alpha=128.0, modalities=("text", "image")),
    )
