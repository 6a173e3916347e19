"""llava-1.5-7b — the paper's primary backbone (LLaVA-1.5 on Vicuna-7B).

[Liu et al. 2024b; paper Tab. 1/2] 32L, d_model=4096, 32 heads (MHA),
d_ff=11008, vocab=32000, CLIP ViT-L/14-336 vision frontend (stubbed,
patch-embedding width 1024) + connector, rank-64 text and image NanoAdapters.
"""
from repro_torch.configs.base import AdapterConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-1.5-7b",
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
        frontend_dim=1024,
        adapter=AdapterConfig(rank=64, alpha=128.0, modalities=("text", "image")),
    )
