"""recurrentgemma-9b — hybrid RG-LRU + local attention, 1 attn : 2 recurrent.

[arXiv:2402.19427 (Griffin) / RecurrentGemma report] 38L, d_model=4096,
16 heads (GQA kv=1 == MQA), d_ff=12288, vocab=256000, RG-LRU recurrence
width 4096, local-attention window 2048, block pattern (rec, rec, attn).

38 layers = 12 full (rec, rec, attn) triples + 2 trailing recurrent layers
(``repro_torch.models.transformer.hybrid_split``).
"""
from repro_torch.configs.base import AdapterConfig, ModelConfig, RGLRUConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab_size=256000,
        max_seq_len=8192,
        pos_type="rope",
        rope_theta=10000.0,
        norm="rmsnorm",
        act="geglu",
        rglru=RGLRUConfig(d_rnn=4096, conv_width=4, local_window=2048),
        adapter=AdapterConfig(rank=64, alpha=128.0, modalities=("text",)),
    )
