"""Whisper-style encoder-decoder backbone of the port, audio family
(PyTorch counterpart of ``repro.models.encdec``).

The conv/mel frontend is not implemented in either package: the encoder
takes precomputed frame embeddings (B, enc_seq, frontend_dim) through the
frozen connector. Downstream everything is real: a bidirectional encoder,
a causal decoder with a self-attention KV cache and a cross-attention KV
computed once at prefill, learned positions.

The image NanoAdapter adapts the frame embeddings before the encoder, the
text NanoAdapter the decoder's token embeddings (``repro_torch.core.adapters``).
Only the decoder's causal self-attention reaches the flash kernel under
``cfg.use_pallas``; the encoder and the cross-attention run ``sdpa``, as in
the JAX package. The per-layer params are lists of dicts, the decode state
the JAX package's stacked layout (``DecLayerState`` of (L, B, ...)
``KVCache``s), updated in place.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models.attention import KVCache
from repro_torch.models.layers import init_mlp, init_norm, mlp, norm
from repro_torch.models.transformer import remat_call


class DecLayerState(NamedTuple):
    self_kv: KVCache   # (..., B, capacity, n_kv, hd)
    cross_kv: KVCache  # (..., B, enc_seq_len, n_kv, hd), fixed after prefill


def init_enc_layer(gen, cfg, dtype):
    dev = gen.device
    return {
        "norm1": init_norm(cfg, cfg.d_model, dtype, dev),
        "attn": attn_lib.init_attention(gen, cfg, dtype),
        "norm2": init_norm(cfg, cfg.d_model, dtype, dev),
        "mlp": init_mlp(gen, cfg, dtype),
    }


def init_dec_layer(gen, cfg, dtype):
    dev = gen.device
    return {
        "norm1": init_norm(cfg, cfg.d_model, dtype, dev),
        "self_attn": attn_lib.init_attention(gen, cfg, dtype),
        "norm_x": init_norm(cfg, cfg.d_model, dtype, dev),
        "cross_attn": attn_lib.init_attention(gen, cfg, dtype),
        "norm2": init_norm(cfg, cfg.d_model, dtype, dev),
        "mlp": init_mlp(gen, cfg, dtype),
    }


def init_encdec_stacks(gen, cfg, dtype):
    return {"enc_layers": [init_enc_layer(gen, cfg, dtype) for _ in range(cfg.n_enc_layers)],
            "dec_layers": [init_dec_layer(gen, cfg, dtype) for _ in range(cfg.n_layers)]}


def _enc_layer(cfg, lp, x):
    """One bidirectional encoder layer (``encdec.py:64-68``)."""
    x = x + attn_lib.full_attention(cfg, lp["attn"], norm(cfg, lp["norm1"], x), None,
                                    causal=False)
    return x + mlp(cfg, lp["mlp"], norm(cfg, lp["norm2"], x))


def encode(cfg, stacks, x):
    """Bidirectional encoder. x (B, M, D): frame embeddings, positions added
    by the caller (``encdec.py:65-76``). Each layer goes through
    ``remat_call``: checkpointed in a training forward under ``cfg.remat``,
    run as it is under ``torch.no_grad`` (prefill)."""
    for lp in stacks["enc_layers"]:
        x = remat_call(cfg, _enc_layer, cfg, lp, x)
    return x


def _dec_layer(cfg, lp, x, memory):
    """One decoder layer -> (x, self (k, v), cross (k, v)) (``encdec.py:79-85``)."""
    out, kv = attn_lib.full_attention(cfg, lp["self_attn"], norm(cfg, lp["norm1"], x), None,
                                      causal=True, return_kv=True)
    x = x + out
    out, ckv = attn_lib.full_attention(cfg, lp["cross_attn"], norm(cfg, lp["norm_x"], x), None,
                                       memory=memory, return_kv=True)
    x = x + out
    return x + mlp(cfg, lp["mlp"], norm(cfg, lp["norm2"], x)), kv, ckv


def _dec_body(cfg, lp, x, memory):
    """One decoder layer of the training forward, its KV dropped."""
    return _dec_layer(cfg, lp, x, memory)[0]


def decode_forward(cfg, stacks, x, memory):
    """Teacher-forced decoder over the full target sequence -> (x, aux = 0)
    (``encdec.py:84-92``), each layer through ``remat_call``."""
    for lp in stacks["dec_layers"]:
        x = remat_call(cfg, _dec_body, cfg, lp, x, memory)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def dec_prefill(cfg, stacks, x, memory, capacity: int):
    """Teacher-forced pass that also builds the decode state: each layer's
    self KV seeded at slots [0, S) of ``capacity``, and its cross KV over the
    memory, fixed from here on (``encdec.py:99-118``)."""
    self_kv = _zero_kv(cfg, x.shape[0], capacity, x.dtype, x.device)
    cks, cvs = [], []
    for i, lp in enumerate(stacks["dec_layers"]):
        x, (k, v), (ck, cv) = _dec_layer(cfg, lp, x, memory)
        attn_lib.seed_cache(KVCache(self_kv.k[i], self_kv.v[i]), k, v)
        cks.append(ck)
        cvs.append(cv)
    cross = KVCache(torch.stack(cks), torch.stack(cvs))
    return x, {"layers": DecLayerState(self_kv=self_kv, cross_kv=cross)}


def _self_cache(state, i) -> KVCache:
    kv = state["layers"].self_kv
    return KVCache(kv.k[i], kv.v[i])


def dec_step(cfg, stacks, x, state, pos):
    """One-token decode, x (B, 1, D), pos (B,): self KV written in place at
    each row's position, the cross KV read as prefill left it
    (``encdec.py:121-135``)."""
    cross = state["layers"].cross_kv
    for i, lp in enumerate(stacks["dec_layers"]):
        out, _ = attn_lib.decode_attention(cfg, lp["self_attn"], norm(cfg, lp["norm1"], x), None,
                                           _self_cache(state, i), pos)
        x = x + out
        x = x + attn_lib.cross_decode_attention(cfg, lp["cross_attn"],
                                                norm(cfg, lp["norm_x"], x),
                                                KVCache(cross.k[i], cross.v[i]))
        x = x + mlp(cfg, lp["mlp"], norm(cfg, lp["norm2"], x))
    return x, state


def _zero_kv(cfg, batch: int, slots: int, dtype, device) -> KVCache:
    shape = (cfg.n_layers, batch, slots, cfg.n_kv_heads, cfg.resolved_head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def init_dec_state(cfg, batch: int, capacity: int, dtype, device):
    """{"layers": DecLayerState of (L, B, capacity, n_kv, hd) self KV and
    (L, B, enc_seq_len, n_kv, hd) cross KV}, zero (``encdec.py:138-144``)."""
    return {"layers": DecLayerState(self_kv=_zero_kv(cfg, batch, capacity, dtype, device),
                                    cross_kv=_zero_kv(cfg, batch, cfg.enc_seq_len, dtype,
                                                      device))}
