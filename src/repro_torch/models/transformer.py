"""Decoder stack of the port, dense/vlm family
(PyTorch counterpart of ``repro.models.transformer``).

Layer body: x += attn(norm(x)); x += mlp(norm(x)). The JAX package scans
over per-layer params stacked on a leading axis; here ``params["layers"]`` is
a list of per-layer dicts and the layer loop is a Python loop. The decode
state keeps the JAX package's stacked layout, ``KVCache`` of
(L, B, C, n_kv, hd) tensors, and each layer reads and writes its slice in
place. MoE, SSM, hybrid and encoder-decoder stacks arrive with their
families (ROADMAP queue 1).
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import init_mlp, init_rmsnorm, mlp, rmsnorm

FAMILIES = ("dense", "vlm")


def check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r}: the port runs {FAMILIES}; the moe, ssm, hybrid and "
            "audio families are ROADMAP queue 1, 'The other families'")


def init_dense_layer(gen, cfg, dtype):
    return {
        "norm1": init_rmsnorm(cfg.d_model, dtype, gen.device),
        "attn": attn_lib.init_attention(gen, cfg, dtype),
        "norm2": init_rmsnorm(cfg.d_model, dtype, gen.device),
        "mlp": init_mlp(gen, cfg, dtype),
    }


def init_stack(gen, cfg, dtype):
    check_family(cfg)
    return {"layers": [init_dense_layer(gen, cfg, dtype) for _ in range(cfg.n_layers)]}


def _layer_cache(state, i) -> attn_lib.KVCache:
    """Views of layer i in the stacked state: writes land in the stack."""
    return attn_lib.KVCache(state["layers"].k[i], state["layers"].v[i])


def _attn_prefill(cfg, lp, x, angles, cache):
    h = rmsnorm(lp["norm1"], x)
    out, (k, v) = attn_lib.full_attention(cfg, lp["attn"], h, angles, return_kv=True)
    x = x + out
    x = x + mlp(cfg, lp["mlp"], rmsnorm(lp["norm2"], x))
    attn_lib.seed_cache(cache, k, v)
    return x


def prefill_stack(cfg, stack, x, angles, capacity: int):
    """x (B, S, D) -> (hidden (B, S, D), stacked decode state)."""
    check_family(cfg)
    state = init_decode_state(cfg, x.shape[0], capacity, x.dtype, x.device)
    for i, lp in enumerate(stack["layers"]):
        x = _attn_prefill(cfg, lp, x, angles, _layer_cache(state, i))
    return x, state


def _attn_step(cfg, lp, x, angles, cache, pos):
    h = rmsnorm(lp["norm1"], x)
    out, _ = attn_lib.decode_attention(cfg, lp["attn"], h, angles, cache, pos)
    x = x + out
    return x + mlp(cfg, lp["mlp"], rmsnorm(lp["norm2"], x))


def decode_stack(cfg, stack, x, angles, state, pos):
    """x (B, 1, D), pos (B,) -> (hidden (B, 1, D), state updated in place)."""
    check_family(cfg)
    for i, lp in enumerate(stack["layers"]):
        x = _attn_step(cfg, lp, x, angles, _layer_cache(state, i), pos)
    return x, state


def init_decode_state(cfg, batch: int, capacity: int, dtype, device):
    """Zero decode state: {"layers": KVCache of (L, B, C, n_kv, hd)}."""
    check_family(cfg)
    shape = (cfg.n_layers, batch, capacity, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"layers": attn_lib.KVCache(torch.zeros(shape, dtype=dtype, device=device),
                                       torch.zeros(shape, dtype=dtype, device=device))}
