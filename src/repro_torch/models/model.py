"""Backbone facade of the port, one API over the six families
(PyTorch counterpart of ``repro.models.model``).

    init_backbone(cfg, seed, device)              -> params
    embed_tokens(cfg, params, tokens)             -> (B, S, D)
    connect(cfg, params, feats)                   -> (B, M, D)   connector
    forward(cfg, params, embeds, positions, enc_embeds=None) -> (hidden, aux)
    logits(cfg, params, hidden)                   -> (B, S, V)
    loss_fn(cfg, params, embeds, positions, labels, mask, enc_embeds=None) -> (loss, aux)
    prefill(cfg, params, embeds, positions, capacity, enc_embeds=None, length=None)
                                                  -> (state, hidden)
    decode_step(cfg, params, embed, state, pos, moe_group=None) -> (logits, state)
    init_state(cfg, batch, capacity, dtype, device)

The audio family (whisper) runs the encoder-decoder of
``repro_torch.models.encdec``: ``enc_embeds`` are its connected frame
embeddings, and its decoder adds learned positions to ``embeds``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import encdec, transformer
from repro_torch.models.layers import (
    dense_init,
    embed,
    init_embedding,
    init_learned_pos,
    init_norm,
    chunked_lm_loss,
    lm_loss,
    make_generator,
    norm,
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
             "ssm": (("rmsnorm",), ("swiglu",), ("none",)),
             "hybrid": (("rmsnorm",), ("geglu",), ("rope",)),
             "audio": (("layernorm",), ("gelu",), ("learned",))}


def check_supported(cfg) -> None:
    """Raise for a combination of family and layers that no config of the
    JAX package has, so the port has never been held against it."""
    transformer.check_family(cfg)
    for field, allowed in zip(("norm", "act", "pos_type"), SUPPORTED[cfg.family]):
        if getattr(cfg, field) not in allowed:
            raise NotImplementedError(
                f"{field}={getattr(cfg, field)!r}: the port runs {allowed} for the "
                f"{cfg.family} family")


def init_backbone(cfg, *, seed: int = 0, device="cuda"):
    """Random frozen backbone drawn from a seeded generator on ``device``,
    with the JAX package's leaves (``model.py:40-60``)."""
    check_supported(cfg)
    dtype = param_dtype(cfg)
    gen = make_generator(device, seed)
    dev = gen.device
    params = {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype),
        "final_norm": init_norm(cfg, cfg.d_model, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype)
    if cfg.pos_type == "learned":
        params["pos"] = init_learned_pos(gen, cfg.max_seq_len, cfg.d_model, dtype)
    if cfg.frontend_dim:
        params["connector"] = {
            "w": dense_init(gen, (cfg.frontend_dim, cfg.d_model), dtype),
            "b": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
        }
    if cfg.family == "audio":
        params.update(encdec.init_encdec_stacks(gen, cfg, dtype))
        params["enc_pos"] = init_learned_pos(gen, cfg.enc_seq_len, cfg.d_model, dtype)
        params["enc_final_norm"] = init_norm(cfg, cfg.d_model, dtype, dev)
    else:
        params.update(transformer.init_stack(gen, cfg, dtype))
    return params


def embed_tokens(cfg, params, tokens):
    return embed(params["embed"], tokens)


def connect(cfg, params, feats):
    """Frozen modality connector: (B, M, frontend_dim) -> (B, M, D)."""
    c = params["connector"]
    return feats.to(c["w"].dtype) @ c["w"] + c["b"]


def _add_learned_pos(cfg, params, x, positions):
    """x + the learned position rows of ``positions`` (B, S) (``model.py:75-79``)."""
    if cfg.pos_type != "learned":
        return x
    return x + params["pos"]["pos"][positions].to(x.dtype)


def _encode_memory(cfg, params, enc_embeds):
    """The encoder over connected frame embeddings (B, M, D), after its
    learned positions, through its final norm (``model.py:82-88``)."""
    m = enc_embeds.shape[1]
    mem = enc_embeds + params["enc_pos"]["pos"][:m][None].to(enc_embeds.dtype)
    return norm(cfg, params["enc_final_norm"], encdec.encode(cfg, params, mem))


def _text_positions(positions):
    return positions if positions.ndim == 2 else positions[0]


def forward(cfg, params, embeds, positions, enc_embeds=None, clients=None):
    """Full-sequence causal forward (training and evaluation).

    embeds (B, S, D), adapter-processed; positions (B, S) int, or (3, B, S)
    under M-RoPE; enc_embeds (B, M, D), the connected frame embeddings of
    the audio family. Returns (hidden (B, S, D) after the final norm, aux:
    the MoE balance loss summed over the layers, 0 for the other families).
    ``clients=K``: the B rows are K clients' blocks (the cohort's folded
    pass); aux is then (K,).
    """
    x = _add_learned_pos(cfg, params, embeds, _text_positions(positions))
    angles = make_angles(cfg, positions)
    if cfg.family == "audio":
        x, aux = encdec.decode_forward(cfg, params, x, _encode_memory(cfg, params, enc_embeds))
    else:
        x, aux = transformer.forward_stack(cfg, params, x, angles, clients)
    if clients is not None:
        aux = torch.as_tensor(aux, dtype=torch.float32, device=x.device).expand(clients)
    return norm(cfg, params["final_norm"], x), aux


def logits(cfg, params, hidden):
    """Tied configs read the embedding table (``model.py:111-115``)."""
    return unembed(params["embed" if cfg.tie_embeddings else "unembed"], hidden)


def loss_fn(cfg, params, embeds, positions, labels, mask, enc_embeds=None, clients=None):
    """Masked LM loss of the frozen backbone on adapted embeddings -> (loss, aux).

    aux, the MoE balance loss, is reported and never differentiated (the JAX
    client's ``has_aux``), so it leaves the graph here. A sequence longer
    than ``cfg.loss_chunk`` takes :func:`chunked_lm_loss` on the tied or
    untied table (``model.py:118-127``), else the full (B, S, V) logits are
    formed. ``clients=K`` (rows as in :func:`forward`): loss and aux (K,),
    each client's own.
    """
    hidden, aux = forward(cfg, params, embeds, positions, enc_embeds, clients)
    if cfg.loss_chunk is not None and hidden.shape[1] > cfg.loss_chunk:
        table = params["embed" if cfg.tie_embeddings else "unembed"]["table"]
        loss = chunked_lm_loss(hidden, table, labels, mask, chunk=cfg.loss_chunk,
                               clients=clients)
        return loss, aux.detach()
    return lm_loss(logits(cfg, params, hidden), labels, mask, clients), aux.detach()


def prefill(cfg, params, embeds, positions, capacity: int, enc_embeds=None, length=None):
    """embeds (B, S, D), positions (B, S) or (3, B, S) -> (stacked decode state, hidden).

    ``length`` (int, optional): the number of real positions of a
    right-padded sequence. Only the recurrent families (ssm, hybrid) read
    it, so their terminal state integrates no pad step; the attention and
    encoder-decoder caches ignore it. ``enc_embeds``: the audio family's
    frames, encoded once here into each decoder layer's cross KV.
    """
    x = _add_learned_pos(cfg, params, embeds, _text_positions(positions))
    angles = make_angles(cfg, positions)
    if cfg.family == "audio":
        x, state = encdec.dec_prefill(cfg, params, x, _encode_memory(cfg, params, enc_embeds),
                                      capacity)
    else:
        x, state = transformer.prefill_stack(cfg, params, x, angles, capacity, length=length)
    return state, norm(cfg, params["final_norm"], x)


def decode_step(cfg, params, embed, state, pos, moe_group: Optional[int] = None):
    """One-token decode. embed (B, 1, D); pos (B,) positions, or one int for all rows.

    Returns (logits (B, 1, V), state updated in place).

    ``moe_group`` sets how an MoE layer routes the B rows: None (the
    default) as one group of ``_group_size(B)``, as JAX's
    ``model.decode_step`` does on a batch; 1 each row alone, as the serving
    engine does, where the JAX engine ``vmap``s its decode over pages. The
    two differ where the batch's group capacity drops a choice.
    """
    b = embed.shape[0]
    if not torch.is_tensor(pos):
        pos = torch.full((b,), int(pos), dtype=torch.long, device=embed.device)
    x = _add_learned_pos(cfg, params, embed, pos[:, None])
    angles = make_angles(cfg, pos[:, None])
    if cfg.family == "audio":
        x, state = encdec.dec_step(cfg, params, x, state, pos)
    else:
        x, state = transformer.decode_stack(cfg, params, x, angles, state, pos,
                                            moe_group=moe_group)
    return logits(cfg, params, norm(cfg, params["final_norm"], x)), state


def init_state(cfg, batch: int, capacity: int, dtype, device):
    if cfg.family == "audio":
        return encdec.init_dec_state(cfg, batch, capacity, dtype, device)
    return transformer.init_decode_state(cfg, batch, capacity, dtype, device)
