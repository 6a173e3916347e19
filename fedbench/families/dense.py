"""The dense decoder family: pre-norm grouped-query attention (RoPE or
M-RoPE, optional QKV bias, optional sliding window) and a SwiGLU MLP, with
an optional linear image stub ahead of the text."""
from fedbench.counts import (decode_flops, flash_call, grouped_lora_call,  # noqa: F401
                             prefill_flops, shape_of, train_row_flops)
from fedbench.weights import decoder_leaves


def leaves(cfg: dict):
    return decoder_leaves(shape_of(cfg), bool(cfg.get("qkv_bias")),
                          bool(cfg.get("tie_word_embeddings")))


def port_fields(cfg: dict) -> dict:
    """The port's ``ModelConfig`` fields that the published keys state."""
    s = shape_of(cfg)
    sections = (cfg.get("rope_scaling") or {}).get("mrope_section")
    return dict(
        n_layers=s.layers, d_model=s.d, n_heads=s.heads, n_kv_heads=s.kv_heads,
        head_dim=s.head_dim, d_ff=s.d_ff, vocab_size=s.vocab,
        max_seq_len=cfg["max_position_embeddings"],
        pos_type="mrope" if sections else "rope", rope_theta=float(cfg["rope_theta"]),
        mrope_sections=tuple(sections or ()), qkv_bias=bool(cfg.get("qkv_bias")),
        sliding_window=s.window or None, frontend_dim=s.frontend,
        tie_embeddings=bool(cfg.get("tie_word_embeddings")), dtype=cfg["torch_dtype"])
