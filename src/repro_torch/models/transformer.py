"""Decoder stacks of the port, dense/vlm, moe and ssm families
(PyTorch counterpart of ``repro.models.transformer``).

Layer bodies:
    dense/vlm : x += attn(norm(x)); x += mlp(norm(x))
    moe       : x += attn(norm(x)); x += moe(norm(x))   (+ shared expert)
    ssm       : x += mamba2(norm(x))

The JAX package scans over per-layer params stacked on a leading axis; here
``params["layers"]`` is a list of per-layer dicts and the layer loop is a
Python loop. The decode state keeps the JAX package's stacked layout
(``KVCache`` of (L, B, C, n_kv, hd) tensors, or ``SSMState`` of (L, B, ...)
tensors) and each layer reads and writes its slice in place. Hybrid and
encoder-decoder stacks arrive with their families (ROADMAP queues 3f, 3g).
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import init_mlp, init_rmsnorm, mlp, rmsnorm

FAMILIES = ("dense", "vlm", "moe", "ssm")


def check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r}: the port runs {FAMILIES}; the hybrid family is "
            "ROADMAP queue 3f and the audio family queue 3g")


def init_dense_layer(gen, cfg, dtype):
    return {
        "norm1": init_rmsnorm(cfg.d_model, dtype, gen.device),
        "attn": attn_lib.init_attention(gen, cfg, dtype),
        "norm2": init_rmsnorm(cfg.d_model, dtype, gen.device),
        "mlp": init_mlp(gen, cfg, dtype),
    }


def init_moe_layer(gen, cfg, dtype):
    return {
        "norm1": init_rmsnorm(cfg.d_model, dtype, gen.device),
        "attn": attn_lib.init_attention(gen, cfg, dtype),
        "norm2": init_rmsnorm(cfg.d_model, dtype, gen.device),
        "moe": moe_lib.init_moe(gen, cfg, dtype),
    }


def init_ssm_layer(gen, cfg, dtype):
    return {"norm1": init_rmsnorm(cfg.d_model, dtype, gen.device),
            "ssm": ssm_lib.init_ssm(gen, cfg, dtype)}


def init_stack(gen, cfg, dtype):
    check_family(cfg)
    init = {"ssm": init_ssm_layer, "moe": init_moe_layer}.get(cfg.family, init_dense_layer)
    return {"layers": [init(gen, cfg, dtype) for _ in range(cfg.n_layers)]}


def _layer_cache(state, i) -> attn_lib.KVCache:
    """Views of layer i in the stacked state: writes land in the stack."""
    return attn_lib.KVCache(state["layers"].k[i], state["layers"].v[i])


def dense_body(cfg, lp, x, angles):
    """One attention layer over the full sequence -> (x, (k, v), aux).

    Shared by training (``forward_stack``) and prefill, dense and moe alike;
    aux is the MoE balance loss, 0 for a dense layer. It writes nothing in
    place, so autograd can save its tensors; prefill seeds the cache after.
    """
    h = rmsnorm(lp["norm1"], x)
    out, kv = attn_lib.full_attention(cfg, lp["attn"], h, angles, return_kv=True)
    x = x + out
    y, aux = _ffn(cfg, lp, rmsnorm(lp["norm2"], x))
    return x + y, kv, aux


def _ffn(cfg, lp, h, group=None):
    """The layer's MLP or MoE layer -> (y, balance loss, 0 for an MLP)."""
    if "moe" in lp:
        return moe_lib.moe_apply(cfg, lp["moe"], h, group=group)
    return mlp(cfg, lp["mlp"], h), 0.0


def ssm_body(cfg, lp, x):
    """One Mamba2 layer over the full sequence (``transformer.py:174-177``)."""
    return x + ssm_lib.ssm_apply(cfg, lp["ssm"], rmsnorm(lp["norm1"], x),
                                 use_pallas=cfg.use_pallas)


def forward_stack(cfg, stack, x, angles):
    """Full-sequence causal stack for training: x (B, S, D) -> (hidden, aux).

    aux is the MoE balance loss summed over the layers, 0 for the other
    families (``transformer.py:214-236``). Activations are kept for the
    backward: the JAX package's ``remat`` is a memory option that changes
    no number.
    """
    check_family(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in stack["layers"]:
        if cfg.family == "ssm":
            x = ssm_body(cfg, lp, x)
        else:
            x, _, a = dense_body(cfg, lp, x, angles)
            aux = aux + a
    return x, aux


def prefill_stack(cfg, stack, x, angles, capacity: int, length=None):
    """x (B, S, D) -> (hidden (B, S, D), stacked decode state).

    ``length`` (int, optional) marks only the first ``length`` positions as
    real: the ssm layers keep pad steps out of their terminal state. The
    attention cache ignores it (pad KV is overwritten before decode reads it).
    The caches hold ``cache_capacity(cfg, capacity)`` slots; a prefill longer
    than a ring keeps its last positions (``attention.seed_cache``).
    """
    check_family(cfg)
    state = init_decode_state(cfg, x.shape[0], capacity, x.dtype, x.device)
    for i, lp in enumerate(stack["layers"]):
        if cfg.family == "ssm":
            out, st = ssm_lib.ssm_prefill(cfg, lp["ssm"], rmsnorm(lp["norm1"], x), length,
                                          use_pallas=cfg.use_pallas)
            x = x + out
            _write_ssm_layer(state, i, st)
        else:
            x, (k, v), _ = dense_body(cfg, lp, x, angles)
            attn_lib.seed_cache(_layer_cache(state, i), k, v)
    return x, state


def _write_ssm_layer(state, i, st: ssm_lib.SSMState) -> None:
    """Layer i's new conv window and h, written into the stacked state."""
    state["layers"].conv[i].copy_(st.conv)
    state["layers"].h[i].copy_(st.h)


def _attn_step(cfg, lp, x, angles, cache, pos):
    """One decode layer. An MoE layer routes each row alone (groups of 1),
    as the JAX engine's ``vmap`` over its pages does (``engine.py:175-187``)."""
    h = rmsnorm(lp["norm1"], x)
    out, _ = attn_lib.decode_attention(cfg, lp["attn"], h, angles, cache, pos)
    x = x + out
    return x + _ffn(cfg, lp, rmsnorm(lp["norm2"], x), group=1)[0]


def decode_stack(cfg, stack, x, angles, state, pos):
    """x (B, 1, D), pos (B,) -> (hidden (B, 1, D), state updated in place)."""
    check_family(cfg)
    for i, lp in enumerate(stack["layers"]):
        if cfg.family == "ssm":
            layer = ssm_lib.SSMState(state["layers"].conv[i], state["layers"].h[i])
            out, st = ssm_lib.ssm_decode_step(cfg, lp["ssm"], rmsnorm(lp["norm1"], x), layer)
            x = x + out
            _write_ssm_layer(state, i, st)
        else:
            x = _attn_step(cfg, lp, x, angles, _layer_cache(state, i), pos)
    return x, state


def init_decode_state(cfg, batch: int, capacity: int, dtype, device):
    """Zero decode state: {"layers": KVCache of (L, B, C, n_kv, hd)}, or for
    the ssm family {"layers": SSMState of (L, B, d_conv-1, conv_dim) in
    ``dtype`` and (L, B, H, P, N) in f32}; ``capacity`` is unused there. A
    sliding-window config's caches hold ``cache_capacity`` slots, a ring of
    at most the window (``transformer.py:342``)."""
    check_family(cfg)
    if cfg.family == "ssm":
        one = ssm_lib.init_ssm_state(cfg, batch, dtype, device)
        return {"layers": ssm_lib.SSMState(
            *(t.new_zeros((cfg.n_layers,) + tuple(t.shape)) for t in one))}
    cap = attn_lib.cache_capacity(cfg, capacity)
    shape = (cfg.n_layers, batch, cap, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"layers": attn_lib.KVCache(torch.zeros(shape, dtype=dtype, device=device),
                                       torch.zeros(shape, dtype=dtype, device=device))}
