"""whisper-base — encoder-decoder audio backbone, conv frontend stubbed.

[arXiv:2212.04356] 6 encoder + 6 decoder layers, d_model=512, 8 heads (MHA),
d_ff=2048, vocab=51865, learned positions, LayerNorm + GELU MLP, encoder
memory fixed at 1500 frames.

The mel-spectrogram and conv feature extractor are not implemented: requests
and training rows carry precomputed frame embeddings (1500, 512). The
image NanoAdapter adapts the connected frames (encoder side), the text
NanoAdapter the decoder's token embeddings. The learned decoder position
table has 32,768 rows, the JAX package's (whisper's own has 448).
"""
from repro_torch.configs.base import AdapterConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base",
        family="audio",
        n_layers=6,           # decoder layers
        n_enc_layers=6,
        enc_seq_len=1500,
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        d_ff=2048,
        vocab_size=51865,
        max_seq_len=32768,
        pos_type="learned",
        norm="layernorm",
        act="gelu",
        frontend_dim=512,
        adapter=AdapterConfig(rank=64, alpha=128.0, modalities=("text", "image")),
    )
