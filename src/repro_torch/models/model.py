"""Backbone facade of the port, dense/vlm, moe and ssm families
(PyTorch counterpart of ``repro.models.model``).

    init_backbone(cfg, seed, device)              -> params
    embed_tokens(cfg, params, tokens)             -> (B, S, D)
    connect(cfg, params, feats)                   -> (B, M, D)   connector
    forward(cfg, params, embeds, positions)       -> (hidden, aux)
    logits(cfg, params, hidden)                   -> (B, S, V)
    loss_fn(cfg, params, embeds, positions, labels, mask) -> (loss, aux)
    prefill(cfg, params, embeds, positions, capacity, length) -> (state, hidden)
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


# what each family runs: norm, activations, position types
SUPPORTED = {"dense": (("rmsnorm",), ("swiglu",), ("rope",)),
             "vlm": (("rmsnorm",), ("swiglu",), ("rope", "mrope")),
             "moe": (("rmsnorm",), ("swiglu", "gelu"), ("rope",)),
             "ssm": (("rmsnorm",), ("swiglu",), ("none",))}


def check_supported(cfg) -> None:
    """Raise for configs whose layers the port does not have yet."""
    transformer.check_family(cfg)
    for field, allowed in zip(("norm", "act", "pos_type"), SUPPORTED[cfg.family]):
        if getattr(cfg, field) not in allowed:
            raise NotImplementedError(
                f"{field}={getattr(cfg, field)!r}: the port runs {allowed} for the "
                f"{cfg.family} family (LayerNorm and learned positions: ROADMAP queue 3g; "
                "GeGLU: queue 3f)")


def init_backbone(cfg, *, seed: int = 0, device="cuda"):
    """Random frozen backbone drawn from a seeded generator on ``device``."""
    check_supported(cfg)
    dtype = param_dtype(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype),
        "final_norm": init_rmsnorm(cfg.d_model, dtype, gen.device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype)
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

    embeds (B, S, D), adapter-processed; positions (B, S) int, or (3, B, S)
    under M-RoPE. Returns (hidden (B, S, D) after the final norm, aux: the
    MoE balance loss summed over the layers, 0 for the other families).
    """
    angles = make_angles(cfg, positions)
    x, aux = transformer.forward_stack(cfg, params, embeds, angles)
    return rmsnorm(params["final_norm"], x), aux


def logits(cfg, params, hidden):
    """Tied configs read the embedding table (``model.py:111-115``)."""
    return unembed(params["embed" if cfg.tie_embeddings else "unembed"], hidden)


def loss_fn(cfg, params, embeds, positions, labels, mask):
    """Masked LM loss of the frozen backbone on adapted embeddings -> (loss, aux).

    aux, the MoE balance loss, is reported and never differentiated (the JAX
    client's ``has_aux``), so it leaves the graph here. The port's configs
    have no ``loss_chunk``, so the full (B, S, V) logits are formed, as in
    ``repro.models.model.loss_fn``.
    """
    hidden, aux = forward(cfg, params, embeds, positions)
    return lm_loss(logits(cfg, params, hidden), labels, mask), aux.detach()


def prefill(cfg, params, embeds, positions, capacity: int, length=None):
    """embeds (B, S, D), positions (B, S) or (3, B, S) -> (stacked decode state, hidden).

    ``length`` (int, optional): the number of real positions of a
    right-padded sequence. Only the ssm family reads it (its terminal state
    must not integrate pad steps); the attention cache ignores it.
    """
    angles = make_angles(cfg, positions)
    x, state = transformer.prefill_stack(cfg, params, embeds, angles, capacity, length=length)
    return state, rmsnorm(params["final_norm"], x)


def decode_step(cfg, params, embed, state, pos):
    """One-token decode. embed (B, 1, D); pos (B,) positions, or one int for all rows.

    Returns (logits (B, 1, V), state updated in place).

    An MoE layer routes each row alone (groups of 1): the serving engine's
    semantics, where the JAX engine ``vmap``s its decode over pages. JAX's
    ``model.decode_step`` called on a whole batch routes the B rows as one
    group instead; the two differ where that group's capacity drops a choice.
    """
    b = embed.shape[0]
    if not torch.is_tensor(pos):
        pos = torch.full((b,), int(pos), dtype=torch.long, device=embed.device)
    angles = make_angles(cfg, pos[:, None])
    x, state = transformer.decode_stack(cfg, params, embed, angles, state, pos)
    return logits(cfg, params, rmsnorm(params["final_norm"], x)), state


def init_state(cfg, batch: int, capacity: int, dtype, device):
    return transformer.init_decode_state(cfg, batch, capacity, dtype, device)
