"""Decoder stacks of the port, dense/vlm, moe, ssm and hybrid families
(PyTorch counterpart of ``repro.models.transformer``).

Layer bodies:
    dense/vlm : x += attn(norm(x)); x += mlp(norm(x))
    moe       : x += attn(norm(x)); x += moe(norm(x))   (+ shared expert)
    ssm       : x += mamba2(norm(x))
    hybrid    : n // 3 (rec, rec, attn) triples + n % 3 trailing rec layers
                (recurrentgemma-9b: 12 × 3 + 2), every sub-layer followed by
                its own MLP (Griffin's residual pattern); the attn
                sub-layers use the local window ``rglru.local_window``.

The JAX package scans over per-layer params stacked on a leading axis; here
``params["layers"]`` is a list of per-layer dicts (a hybrid stack:
``params["triples"]``, a list of {"rec0", "rec1", "attn"} dicts, and
``params["extras"]``, a list or None) and the layer loop is a Python loop.
The decode state keeps the JAX package's stacked layout (``KVCache`` of
(L, B, C, n_kv, hd) tensors, ``SSMState`` or ``RGLRUState`` of (L, B, ...)
tensors) and each layer reads and writes its slice in place. The
encoder-decoder stack of the audio family is ``repro_torch.models.encdec``.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import init_mlp, init_norm, mlp, norm
from repro_torch.utils.trace import span

FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")


def check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r}: the port runs {FAMILIES}")


def _attn_cfg(cfg):
    """Attention-sublayer view of the config: a hybrid stack's attention
    sees the local window (``transformer.py:40-44``)."""
    if cfg.family == "hybrid":
        return cfg.with_(sliding_window=cfg.rglru.local_window)
    return cfg


def init_dense_layer(gen, cfg, dtype):
    dev = gen.device
    return {
        "norm1": init_norm(cfg, cfg.d_model, dtype, dev),
        "attn": attn_lib.init_attention(gen, cfg, dtype),
        "norm2": init_norm(cfg, cfg.d_model, dtype, dev),
        "mlp": init_mlp(gen, cfg, dtype),
    }


def init_moe_layer(gen, cfg, dtype):
    dev = gen.device
    return {
        "norm1": init_norm(cfg, cfg.d_model, dtype, dev),
        "attn": attn_lib.init_attention(gen, cfg, dtype),
        "norm2": init_norm(cfg, cfg.d_model, dtype, dev),
        "moe": moe_lib.init_moe(gen, cfg, dtype),
    }


def init_ssm_layer(gen, cfg, dtype):
    return {"norm1": init_norm(cfg, cfg.d_model, dtype, gen.device),
            "ssm": ssm_lib.init_ssm(gen, cfg, dtype)}


def init_rec_layer(gen, cfg, dtype):
    dev = gen.device
    return {
        "norm1": init_norm(cfg, cfg.d_model, dtype, dev),
        "rgl": rglru_lib.init_rglru(gen, cfg, dtype),
        "norm2": init_norm(cfg, cfg.d_model, dtype, dev),
        "mlp": init_mlp(gen, cfg, dtype),
    }


def hybrid_split(cfg):
    """(n_triples, n_extra_rec): 38 = 12 × 3 + 2 for recurrentgemma-9b. The
    stack is built of (rec, rec, attn) triples, the only ``block_pattern``
    the JAX package builds; another pattern is refused."""
    if tuple(cfg.rglru.block_pattern) != ("rec", "rec", "attn"):
        raise ValueError(f"{cfg.name}: the hybrid stack is built of (rec, rec, attn) "
                         f"triples, not block_pattern={cfg.rglru.block_pattern}")
    n_triples = cfg.n_layers // 3
    return n_triples, cfg.n_layers - 3 * n_triples


def init_stack(gen, cfg, dtype):
    check_family(cfg)
    if cfg.family == "hybrid":
        n_t, n_e = hybrid_split(cfg)
        triples = [{"rec0": init_rec_layer(gen, cfg, dtype),
                    "rec1": init_rec_layer(gen, cfg, dtype),
                    "attn": init_dense_layer(gen, _attn_cfg(cfg), dtype)} for _ in range(n_t)]
        extras = [init_rec_layer(gen, cfg, dtype) for _ in range(n_e)] or None
        return {"triples": triples, "extras": extras}
    init = {"ssm": init_ssm_layer, "moe": init_moe_layer}.get(cfg.family, init_dense_layer)
    return {"layers": [init(gen, cfg, dtype) for _ in range(cfg.n_layers)]}


def _layer_cache(layers, i) -> attn_lib.KVCache:
    """Views of layer i in a stacked KVCache: writes land in the stack."""
    return attn_lib.KVCache(layers.k[i], layers.v[i])


def _write_layer(stacked, i, st) -> None:
    """Layer i's new recurrent state (an ``SSMState`` or ``RGLRUState``),
    written field by field into the stacked state."""
    for dst, src in zip(stacked, st):
        dst[i].copy_(src)


def _layer_state(stacked, i):
    return type(stacked)(*(t[i] for t in stacked))


def dense_body(cfg, lp, x, angles, clients=None):
    """One attention layer over the full sequence -> (x, (k, v), aux).

    Shared by training (``forward_stack``) and prefill, dense, moe and the
    hybrid stack's attention alike; aux is the MoE balance loss, 0 for a
    dense layer. It writes nothing in place, so autograd can save its
    tensors; prefill seeds the cache after. ``clients``: the rows are that
    many clients' blocks (``moe_apply``).
    """
    with span("nano.model.attention"):
        h = norm(cfg, lp["norm1"], x)
        out, kv = attn_lib.full_attention(cfg, lp["attn"], h, angles, return_kv=True)
        x = x + out
    with span("nano.model.ffn"):
        y, aux = _ffn(cfg, lp, norm(cfg, lp["norm2"], x), clients=clients)
        return x + y, kv, aux


def _ffn(cfg, lp, h, group=None, clients=None):
    """The layer's MLP or MoE layer -> (y, balance loss, 0 for an MLP)."""
    if "moe" in lp:
        return moe_lib.moe_apply(cfg, lp["moe"], h, group=group, clients=clients)
    return mlp(cfg, lp["mlp"], h), 0.0


def ssm_body(cfg, lp, x):
    """One Mamba2 layer over the full sequence (``transformer.py:174-177``)."""
    return x + ssm_lib.ssm_apply(cfg, lp["ssm"], norm(cfg, lp["norm1"], x),
                                 use_pallas=cfg.use_pallas)


def rec_prefill(cfg, lp, x, length=None):
    """One recurrent layer and its MLP over the full sequence -> (x, RGLRUState)
    (``transformer.py:180-183, 268-273``)."""
    out, st = rglru_lib.rglru_block_prefill(cfg, lp["rgl"], norm(cfg, lp["norm1"], x),
                                            length=length)
    x = x + out
    return x + mlp(cfg, lp["mlp"], norm(cfg, lp["norm2"], x)), st


def remat_call(cfg, body, *args):
    """``body(*args)``, one layer body of a training forward: under
    ``torch.utils.checkpoint`` (non-reentrant) when ``cfg.remat`` is on and
    grad is enabled, as the JAX package wraps its scanned body in
    ``jax.checkpoint`` (``transformer.py:214-236``). The forward then keeps
    only the body's inputs, and the backward runs the body once more to
    rebuild what it needs (kernels included), stopping after the last saved
    tensor. Under ``torch.no_grad`` or ``inference_mode`` (evaluation,
    prefill, decode) the body runs once as it is. The bodies draw no random
    numbers, so no RNG state is kept for the recompute; they are
    deterministic, so the recomputed tensors' shapes and dtypes are not
    checked again (the check costs host time on every saved tensor of a
    host-bound step; ``tests/test_torch_remat.py`` holds remat on against
    off to the bit). While the backward runs a body again, ``recomputing()``
    is true."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(body, *args, use_reentrant=False, preserve_rng_state=False,
                          determinism_check="none",
                          context_fn=lambda: (contextlib.nullcontext(), _recompute_scope()))
    return body(*args)


class _Recompute(threading.local):
    depth = 0


_RECOMPUTE = _Recompute()


@contextlib.contextmanager
def _recompute_scope():
    _RECOMPUTE.depth += 1
    try:
        yield
    finally:
        _RECOMPUTE.depth -= 1


def recomputing() -> bool:
    """Whether this call runs inside the backward's second forward of a
    ``remat_call`` body (in the thread that runs it): a call made there
    repeats one of the forward's, on the same inputs."""
    return _RECOMPUTE.depth > 0


def _layer_body(cfg, lp, x, angles, clients):
    """One dense/vlm/moe layer -> (x, aux), its (k, v) dropped."""
    x, _, aux = dense_body(cfg, lp, x, angles, clients)
    return x, aux


def _triple_body(cfg, lp, x, angles):
    """One hybrid (rec, rec, attn) triple, each sub-layer with its MLP."""
    x = rec_prefill(cfg, lp["rec0"], x)[0]
    x = rec_prefill(cfg, lp["rec1"], x)[0]
    return dense_body(_attn_cfg(cfg), lp["attn"], x, angles)[0]


def _rec_body(cfg, lp, x):
    """One trailing recurrent layer and its MLP."""
    return rec_prefill(cfg, lp, x)[0]


def forward_stack(cfg, stack, x, angles, clients=None):
    """Full-sequence causal stack for training: x (B, S, D) -> (hidden, aux).

    aux is the MoE balance loss summed over the layers, 0 for the other
    families (``transformer.py:214-253``). Each layer body (a dense/vlm/moe
    or ssm layer, a hybrid triple, a trailing rec layer) goes through
    ``remat_call``: with ``cfg.remat`` a training forward keeps each body's
    input only and its backward runs the body's forward once more; the loss
    and the gradients are the same. ``clients=K``: the B rows are K clients'
    blocks; only the MoE layers read it (routing groups within a client,
    aux (K,)), every other layer is row-local.
    """
    check_family(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "hybrid":
        for lp in stack["triples"]:
            x = remat_call(cfg, _triple_body, cfg, lp, x, angles)
        for lp in stack["extras"] or []:
            x = remat_call(cfg, _rec_body, cfg, lp, x)
        return x, aux
    for lp in stack["layers"]:
        if cfg.family == "ssm":
            x = remat_call(cfg, ssm_body, cfg, lp, x)
        else:
            x, a = remat_call(cfg, _layer_body, cfg, lp, x, angles, clients)
            aux = aux + a
    return x, aux


def prefill_stack(cfg, stack, x, angles, capacity: int, length=None):
    """x (B, S, D) -> (hidden (B, S, D), stacked decode state).

    ``length`` (int, optional) marks only the first ``length`` positions as
    real: the recurrent layers (ssm, and the hybrid stack's rec sub-layers)
    keep pad steps out of their terminal state. The attention cache ignores
    it (pad KV is overwritten before decode reads it). The caches hold
    ``cache_capacity(cfg, capacity)`` slots; a prefill longer than a ring
    keeps its last positions (``attention.seed_cache``).
    """
    check_family(cfg)
    state = init_decode_state(cfg, x.shape[0], capacity, x.dtype, x.device)
    if cfg.family == "hybrid":
        acfg, tri = _attn_cfg(cfg), state["triples"]
        for i, lp in enumerate(stack["triples"]):
            x, st = rec_prefill(cfg, lp["rec0"], x, length)
            _write_layer(tri["rec0"], i, st)
            x, st = rec_prefill(cfg, lp["rec1"], x, length)
            _write_layer(tri["rec1"], i, st)
            x, (k, v), _ = dense_body(acfg, lp["attn"], x, angles)
            attn_lib.seed_cache(_layer_cache(tri["attn"], i), k, v)
        for i, lp in enumerate(stack["extras"] or []):
            x, st = rec_prefill(cfg, lp, x, length)
            _write_layer(state["extras"], i, st)
        return x, state
    for i, lp in enumerate(stack["layers"]):
        if cfg.family == "ssm":
            out, st = ssm_lib.ssm_prefill(cfg, lp["ssm"], norm(cfg, lp["norm1"], x), length,
                                          use_pallas=cfg.use_pallas)
            x = x + out
            _write_layer(state["layers"], i, st)
        else:
            x, (k, v), _ = dense_body(cfg, lp, x, angles)
            attn_lib.seed_cache(_layer_cache(state["layers"], i), k, v)
    return x, state


def _attn_step(cfg, lp, x, angles, cache, pos, moe_group: Optional[int]):
    """One decode layer of attention and its MLP or MoE layer."""
    with span("nano.model.attention"):
        h = norm(cfg, lp["norm1"], x)
        out, _ = attn_lib.decode_attention(cfg, lp["attn"], h, angles, cache, pos)
        x = x + out
    with span("nano.model.ffn"):
        return x + _ffn(cfg, lp, norm(cfg, lp["norm2"], x), group=moe_group)[0]


def _rec_step(cfg, lp, x, stacked, i):
    """One decode step of a recurrent layer and its MLP; layer i of the
    stacked ``RGLRUState`` is updated in place."""
    out, st = rglru_lib.rglru_block_step(cfg, lp["rgl"], norm(cfg, lp["norm1"], x),
                                         _layer_state(stacked, i))
    _write_layer(stacked, i, st)
    x = x + out
    return x + mlp(cfg, lp["mlp"], norm(cfg, lp["norm2"], x))


def decode_stack(cfg, stack, x, angles, state, pos, moe_group: Optional[int] = None):
    """x (B, 1, D), pos (B,) -> (hidden (B, 1, D), state updated in place).

    ``moe_group`` is the MoE layers' routing group: None routes the B rows as
    one group of ``_group_size(B)``, as the JAX package's ``model.decode_step``
    does on a batch (``moe.py:57-62``); 1 routes each row alone, as the JAX
    engine's ``vmap`` over its pages does (``engine.py:175-187``).
    """
    check_family(cfg)
    if cfg.family == "hybrid":
        acfg, tri = _attn_cfg(cfg), state["triples"]
        for i, lp in enumerate(stack["triples"]):
            x = _rec_step(cfg, lp["rec0"], x, tri["rec0"], i)
            x = _rec_step(cfg, lp["rec1"], x, tri["rec1"], i)
            x = _attn_step(acfg, lp["attn"], x, angles, _layer_cache(tri["attn"], i), pos, None)
        for i, lp in enumerate(stack["extras"] or []):
            x = _rec_step(cfg, lp, x, state["extras"], i)
        return x, state
    for i, lp in enumerate(stack["layers"]):
        if cfg.family == "ssm":
            out, st = ssm_lib.ssm_decode_step(cfg, lp["ssm"], norm(cfg, lp["norm1"], x),
                                              _layer_state(state["layers"], i))
            x = x + out
            _write_layer(state["layers"], i, st)
        else:
            x = _attn_step(cfg, lp, x, angles, _layer_cache(state["layers"], i), pos, moe_group)
    return x, state


def _stacked(one, n: int):
    """n zero copies of a per-layer state namedtuple, stacked on a leading axis."""
    return type(one)(*(t.new_zeros((n,) + tuple(t.shape)) for t in one))


def init_decode_state(cfg, batch: int, capacity: int, dtype, device):
    """Zero decode state: {"layers": KVCache of (L, B, C, n_kv, hd)}, or for
    the ssm family {"layers": SSMState of (L, B, d_conv-1, conv_dim) in
    ``dtype`` and (L, B, H, P, N) in f32}; ``capacity`` is unused there. A
    sliding-window config's caches hold ``cache_capacity`` slots, a ring of
    at most the window (``transformer.py:342``). The hybrid family's
    {"triples": {"rec0", "rec1": RGLRUState of (n_t, B, cw-1, d_rnn) in
    ``dtype`` and (n_t, B, d_rnn) in f32, "attn": KVCache of a ring of at
    most the local window}, "extras": RGLRUState of (n_e, ...) or None}
    (``transformer.py:425-448``)."""
    check_family(cfg)
    if cfg.family == "hybrid":
        n_t, n_e = hybrid_split(cfg)
        one = rglru_lib.init_rglru_state(cfg, batch, dtype, device)
        return {"triples": {"rec0": _stacked(one, n_t), "rec1": _stacked(one, n_t),
                            "attn": _kv_state(_attn_cfg(cfg), n_t, batch, capacity, dtype,
                                              device)},
                "extras": _stacked(one, n_e) if n_e else None}
    if cfg.family == "ssm":
        return {"layers": _stacked(ssm_lib.init_ssm_state(cfg, batch, dtype, device),
                                   cfg.n_layers)}
    return {"layers": _kv_state(cfg, cfg.n_layers, batch, capacity, dtype, device)}


def _kv_state(cfg, n: int, batch: int, capacity: int, dtype, device) -> attn_lib.KVCache:
    cap = attn_lib.cache_capacity(cfg, capacity)
    shape = (n, batch, cap, cfg.n_kv_heads, cfg.resolved_head_dim)
    return attn_lib.KVCache(torch.zeros(shape, dtype=dtype, device=device),
                            torch.zeros(shape, dtype=dtype, device=device))
