"""qwen2-vl-72b — VLM decoder with M-RoPE and dynamic-resolution vision input.

[arXiv:2409.12191] 80L, d_model=8192, 64 heads (GQA kv=8), d_ff=29568,
vocab=152064, M-RoPE sections (t=16, h=24, w=24) over head_dim=128,
QKV bias (qwen2 family). Vision frontend (ViT + merger) is a stub: requests
and training batches carry 64 patch embeddings of width 1280 (the real ViT
output dim), which the connector projects to d_model.

This is the paper's own setting (both NanoAdapter-I and NanoAdapter-T).
"""
from repro_torch.configs.base import AdapterConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b",
        family="vlm",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=29568,
        vocab_size=152064,
        max_seq_len=32768,
        pos_type="mrope",
        rope_theta=1000000.0,
        mrope_sections=(16, 24, 24),
        qkv_bias=True,
        norm="rmsnorm",
        act="swiglu",
        frontend_dim=1280,
        adapter=AdapterConfig(rank=64, alpha=128.0, modalities=("text", "image")),
    )
