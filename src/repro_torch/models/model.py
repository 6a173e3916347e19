"""Backbone facade of the port, dense/vlm families
(PyTorch counterpart of ``repro.models.model``).

    init_backbone(cfg, seed, device)              -> params
    embed_tokens(cfg, params, tokens)             -> (B, S, D)
    connect(cfg, params, feats)                   -> (B, M, D)   connector
    forward(cfg, params, embeds, positions)       -> (hidden, aux)
    logits(cfg, params, hidden)                   -> (B, S, V)
    loss_fn(cfg, params, embeds, positions, labels, mask) -> (loss, aux)
    prefill(cfg, params, embeds, positions, capacity) -> (state, hidden)
    decode_step(cfg, params, embed, state, pos)   -> (logits, state)
    init_state(cfg, batch, capacity, dtype, device)
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer
from repro_torch.models.layers import (
    dense_init,
    embed,
    init_embedding,
    init_rmsnorm,
    lm_loss,
    rmsnorm,
    torch_dtype,
    unembed,
)
from repro_torch.models.rotary import make_angles


def param_dtype(cfg) -> torch.dtype:
    return torch_dtype(cfg.dtype)


def check_supported(cfg) -> None:
    """Raise for configs whose layers the port does not have yet."""
    transformer.check_family(cfg)
    for field, want in (("norm", "rmsnorm"), ("act", "swiglu"), ("pos_type", "rope")):
        if getattr(cfg, field) != want:
            raise NotImplementedError(
                f"{field}={getattr(cfg, field)!r}: the port runs {want} only "
                "(ROADMAP queue 3, 'The other families')")


def init_backbone(cfg, *, seed: int = 0, device="cuda"):
    """Random frozen backbone drawn from a seeded generator on ``device``."""
    check_supported(cfg)
    dtype = param_dtype(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype),
        "final_norm": init_rmsnorm(cfg.d_model, dtype, gen.device),
        "unembed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype),
    }
    if cfg.frontend_dim:
        params["connector"] = {
            "w": dense_init(gen, (cfg.frontend_dim, cfg.d_model), dtype),
            "b": torch.zeros((cfg.d_model,), dtype=dtype, device=gen.device),
        }
    params.update(transformer.init_stack(gen, cfg, dtype))
    return params


def embed_tokens(cfg, params, tokens):
    return embed(params["embed"], tokens)


def connect(cfg, params, feats):
    """Frozen modality connector: (B, M, frontend_dim) -> (B, M, D)."""
    c = params["connector"]
    return feats.to(c["w"].dtype) @ c["w"] + c["b"]


def forward(cfg, params, embeds, positions):
    """Full-sequence causal forward (training and evaluation).

    embeds (B, S, D), adapter-processed; positions (B, S) int.
    Returns (hidden (B, S, D) after the final norm, aux scalar).
    """
    angles = make_angles(cfg, positions)
    x, aux = transformer.forward_stack(cfg, params, embeds, angles)
    return rmsnorm(params["final_norm"], x), aux


def logits(cfg, params, hidden):
    return unembed(params["unembed"], hidden)


def loss_fn(cfg, params, embeds, positions, labels, mask):
    """Masked LM loss of the frozen backbone on adapted embeddings -> (loss, aux).

    The port's configs have no ``loss_chunk`` (llava sets none), so the full
    (B, S, V) logits are formed, as in ``repro.models.model.loss_fn``.
    """
    hidden, aux = forward(cfg, params, embeds, positions)
    return lm_loss(logits(cfg, params, hidden), labels, mask), aux


def prefill(cfg, params, embeds, positions, capacity: int):
    """embeds (B, S, D), positions (B, S) -> (stacked decode state, hidden)."""
    angles = make_angles(cfg, positions)
    x, state = transformer.prefill_stack(cfg, params, embeds, angles, capacity)
    return state, rmsnorm(params["final_norm"], x)


def decode_step(cfg, params, embed, state, pos):
    """One-token decode. embed (B, 1, D); pos (B,) positions, or one int for all rows.

    Returns (logits (B, 1, V), state updated in place).
    """
    b = embed.shape[0]
    if not torch.is_tensor(pos):
        pos = torch.full((b,), int(pos), dtype=torch.long, device=embed.device)
    angles = make_angles(cfg, pos[:, None])
    x, state = transformer.decode_stack(cfg, params, embed, angles, state, pos)
    return logits(cfg, params, rmsnorm(params["final_norm"], x)), state


def init_state(cfg, batch: int, capacity: int, dtype, device):
    return transformer.init_decode_state(cfg, batch, capacity, dtype, device)
