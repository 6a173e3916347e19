"""mamba2-130m: attention-free SSM with SSD (state space duality).

[arXiv:2405.21060] 24L, d_model=768, d_ff=0 (the Mamba2 block replaces both
mixer and MLP), vocab=50280, ssm_state=128, expand=2 (d_inner=1536), SSD
head_dim=64 (24 SSD heads), conv width 4, tied embeddings. The chunked SSD
scan runs on the hand-written kernel of ``csrc/ssd_scan.cu``.
"""
from repro_torch.configs.base import AdapterConfig, ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m",
        family="ssm",
        n_layers=24,
        d_model=768,
        n_heads=24,          # SSD heads = d_inner / head_dim
        n_kv_heads=24,
        d_ff=0,
        vocab_size=50280,
        max_seq_len=1048576,
        pos_type="none",
        norm="rmsnorm",
        tie_embeddings=True,
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk_size=256),
        adapter=AdapterConfig(rank=64, alpha=128.0, modalities=("text",)),
    )
