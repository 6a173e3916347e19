"""Attention of the port (PyTorch counterpart of ``repro.models.attention``).

Layout conventions, as in the JAX package:
    x           (B, S, D)
    q           (B, S, n_heads, head_dim)
    k, v        (B, S, n_kv,   head_dim)
    cache k/v   (B, C, n_kv,   head_dim)   C = cache capacity
RoPE is applied before caching, so decode never re-rotates history.

Decode takes one position per batch row: the batch-dimension counterpart of
the JAX engine's ``vmap`` over pool pages, each page at its own position.
The caches are updated in place where the JAX package returns new arrays.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.layers import dense_init
from repro_torch.models.rotary import apply_rotary

NEG_INF = -2.0e38


class KVCache(NamedTuple):
    k: torch.Tensor  # (..., B, C, n_kv, head_dim)
    v: torch.Tensor


def init_attention(gen, cfg, dtype):
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    return {
        "wq": dense_init(gen, (d, nh * hd), dtype),
        "wk": dense_init(gen, (d, nkv * hd), dtype),
        "wv": dense_init(gen, (d, nkv * hd), dtype),
        "wo": dense_init(gen, (nh * hd, d), dtype, scale=(nh * hd) ** -0.5),
    }


def _project_q(cfg, params, x):
    B, S, _ = x.shape
    return (x @ params["wq"]).reshape(B, S, cfg.n_heads, cfg.resolved_head_dim)


def _project_kv(cfg, params, x):
    B, S, _ = x.shape
    shape = (B, S, cfg.n_kv_heads, cfg.resolved_head_dim)
    return (x @ params["wk"]).reshape(shape), (x @ params["wv"]).reshape(shape)


def sdpa(cfg, q, k, v, mask):
    """Grouped-GQA scaled-dot-product attention (the plain path).

    q (B,Sq,nh,hd); k,v (B,Sk,n_kv,hd) unrepeated; mask (Sq, Sk) bool
    (True = attend) or None. Scores in f32; probabilities cast to v's dtype
    before the product with v, as the JAX package does.
    """
    B, Sq, nh, hd = q.shape
    nkv = k.shape[2]
    qg = q.reshape(B, Sq, nkv, nh // nkv, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * (hd ** -0.5)
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(B, Sq, nh, hd)


def causal_mask(s: int, device=None):
    """(S, S) boolean mask, True where key position <= query position."""
    pos = torch.arange(s, device=device)
    return pos[None, :] <= pos[:, None]


def full_attention(cfg, params, x, angles, *, return_kv: bool = False):
    """Causal full-sequence self-attention for prefill.

    ``cfg.use_pallas`` routes the scores through the flash-attention kernel
    (``attention.py:196-202``). Returns (out, (k, v)) when ``return_kv``.
    """
    q = _project_q(cfg, params, x)
    k, v = _project_kv(cfg, params, x)
    q = apply_rotary(q, angles)
    k = apply_rotary(k, angles)
    if cfg.use_pallas:
        out = flash_ops.flash_attention(q, k, v, causal=True)
    else:
        out = sdpa(cfg, q, k, v, causal_mask(x.shape[1], device=x.device))
    B, S = x.shape[:2]
    out = out.reshape(B, S, cfg.n_heads * cfg.resolved_head_dim) @ params["wo"]
    if return_kv:
        return out, (k, v)
    return out


# ---------------------------------------------------------------------------
# KV-cache decode
# ---------------------------------------------------------------------------

def seed_cache(cache: KVCache, k, v) -> KVCache:
    """Write prefill KV (already rotated) into cache slots [0, S).

    In place: the JAX package's ``dynamic_update_slice`` returns a new cache.
    The sliding-window ring arrives with the SWA configs (ROADMAP queue 3).
    """
    S = k.shape[1]
    cache.k[:, :S] = k
    cache.v[:, :S] = v
    return cache


def decode_attention(cfg, params, x, angles, cache: KVCache, pos):
    """One-token decode: x (B, 1, D), pos (B,) int, one absolute position per row.

    Row b writes its new KV at slot ``pos[b] % C`` in place (the JAX package
    returns a new cache) and attends over slots ``j <= pos[b]``
    (``attention.py:269-274``). Scores in f32; probabilities cast to the cache
    dtype before the product with V (``attention.py:292-298``).
    Returns (out (B, 1, D), cache).
    """
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    C = cache.k.shape[1]
    q = apply_rotary(_project_q(cfg, params, x), angles)
    k, v = _project_kv(cfg, params, x)
    k = apply_rotary(k, angles)
    rows = torch.arange(B, device=x.device)
    slot = torch.remainder(pos, C)
    cache.k[rows, slot] = k[:, 0].to(cache.k.dtype)
    cache.v[rows, slot] = v[:, 0].to(cache.v.dtype)
    valid = torch.arange(C, device=x.device)[None, :] <= pos[:, None]  # (B, C)
    nkv = cfg.n_kv_heads
    qg = q.reshape(B, 1, nkv, cfg.n_heads // nkv, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), cache.k.float()) * (hd ** -0.5)
    logits = logits.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(cache.v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, cache.v)
    return out.reshape(B, 1, cfg.n_heads * hd) @ params["wo"], cache
