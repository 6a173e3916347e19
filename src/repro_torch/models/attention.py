"""Attention of the port (PyTorch counterpart of ``repro.models.attention``).

Layout conventions, as in the JAX package:
    x           (B, S, D)
    q           (B, S, n_heads, head_dim)
    k, v        (B, S, n_kv,   head_dim)
    cache k/v   (B, C, n_kv,   head_dim)   C = cache capacity
RoPE is applied before caching, so decode never re-rotates history.
Sliding-window configs decode from a ring buffer of capacity ``window``:
the mask needs only slot validity, never slot age.

Decode takes one position per batch row: the batch-dimension counterpart of
the JAX engine's ``vmap`` over pool pages, each page at its own position.
The caches are updated in place where the JAX package returns new arrays.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.layers import dense_init
from repro_torch.models.rotary import apply_rotary

NEG_INF = -2.0e38


class KVCache(NamedTuple):
    k: torch.Tensor  # (..., B, C, n_kv, head_dim)
    v: torch.Tensor


def init_attention(gen, cfg, dtype):
    """Projections, and with ``cfg.qkv_bias`` zero q/k/v biases, as the JAX
    package initializes them (``attention.py:47-50``)."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": dense_init(gen, (d, nh * hd), dtype),
        "wk": dense_init(gen, (d, nkv * hd), dtype),
        "wv": dense_init(gen, (d, nkv * hd), dtype),
        "wo": dense_init(gen, (nh * hd, d), dtype, scale=(nh * hd) ** -0.5),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", nh * hd), ("bk", nkv * hd), ("bv", nkv * hd)):
            p[name] = torch.zeros((n,), dtype=dtype, device=gen.device)
    return p


def _project_q(cfg, params, x):
    B, S, _ = x.shape
    q = x @ params["wq"]
    if "bq" in params:
        q = q + params["bq"].to(q.dtype)
    return q.reshape(B, S, cfg.n_heads, cfg.resolved_head_dim)


def _project_kv(cfg, params, x):
    B, S, _ = x.shape
    k, v = x @ params["wk"], x @ params["wv"]
    if "bk" in params:
        k = k + params["bk"].to(k.dtype)
        v = v + params["bv"].to(v.dtype)
    shape = (B, S, cfg.n_kv_heads, cfg.resolved_head_dim)
    return k.reshape(shape), v.reshape(shape)


def _softcap(logits, cap: float):
    """grok-1's tanh cap on the scaled logits: cap · tanh(logits / cap)."""
    if cap and cap > 0.0:
        return torch.tanh(logits / cap) * cap
    return logits


def sdpa(cfg, q, k, v, mask):
    """Grouped-GQA scaled-dot-product attention (the plain path).

    q (B,Sq,nh,hd); k,v (B,Sk,n_kv,hd) unrepeated; mask (Sq, Sk) bool
    (True = attend) or None. Scores in f32, capped by ``cfg.logit_softcap``
    before the mask; probabilities cast to v's dtype before the product with
    v, as the JAX package does (``attention.py:85-106``).
    """
    B, Sq, nh, hd = q.shape
    nkv = k.shape[2]
    qg = q.reshape(B, Sq, nkv, nh // nkv, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * (hd ** -0.5)
    logits = _softcap(logits, cfg.logit_softcap)
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(B, Sq, nh, hd)


def chunked_sdpa(cfg, q, k, v, *, chunk: int):
    """Causal (and, with ``cfg.sliding_window``, windowed) attention over query
    chunks, the plain path's memory-bounded form (``attention.py:114-151``).

    Only one chunk's (B, n_kv, g, chunk, S) f32 logits are live at a time
    instead of sdpa's (B, n_kv, g, S, S): at 32,768 positions the full
    scores of one h2o-danube layer would take 137 GB a row. Each chunk's mask
    is built from absolute positions; the last chunk is padded with zero
    queries and cut after, as the JAX package pads it. A Python loop over
    chunks stands in for ``lax.scan``. Equal to :func:`sdpa` with the
    causal (windowed) mask, row by row.
    """
    B, S, nh, hd = q.shape
    nkv = k.shape[2]
    g = nh // nkv
    pad = (-S) % chunk
    if pad:
        q = torch.cat([q, q.new_zeros((B, pad, nh, hd))], dim=1)
    kf = k.float()
    kpos = torch.arange(S, device=q.device)[None, :]
    outs = []
    for start in range(0, S + pad, chunk):
        qc = q[:, start:start + chunk].reshape(B, chunk, nkv, g, hd)
        logits = torch.einsum("bqkgd,bskd->bkgqs", qc.float(), kf) * (hd ** -0.5)
        logits = _softcap(logits, cfg.logit_softcap)
        qpos = torch.arange(start, start + chunk, device=q.device)[:, None]
        m = kpos <= qpos
        if cfg.sliding_window is not None:
            m = m & (qpos - kpos < cfg.sliding_window)
        probs = torch.softmax(logits.masked_fill(~m, NEG_INF), dim=-1).to(v.dtype)
        outs.append(torch.einsum("bkgqs,bskd->bqkgd", probs, v))
    out = torch.cat(outs, dim=1).reshape(B, S + pad, nh, hd)
    return out[:, :S] if pad else out


def causal_mask(sq: int, sk: int, *, q_offset: int = 0, window: Optional[int] = None,
                device=None):
    """(Sq, Sk) boolean mask, True = attend. Query i has absolute position
    q_offset + i; with ``window`` it sees the last ``window`` keys only."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(sk, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m = m & (qpos - kpos < window)
    return m


def full_attention(cfg, params, x, angles, *, causal: bool = True, memory=None,
                   return_kv: bool = False):
    """Full-sequence attention for training and prefill (``attention.py:162-215``).

    Causal self-attention by default, or bidirectional (``causal=False``, the
    encoder's); ``memory`` (B, M, D) makes it cross-attention: keys and values
    from the memory, no mask, no rotary. Rotary only where ``angles`` is given
    (learned positions have none). Causal self-attention takes, in the JAX
    package's order (``attention.py:196-211``): the flash-attention kernel
    under ``cfg.use_pallas``, with the config's window and logit softcap;
    else :func:`chunked_sdpa` where the sequence is longer than
    ``cfg.attn_chunk``; else ``sdpa``. The encoder and the cross-attention
    take ``sdpa``, as in the JAX package.
    Returns (out, (k, v)) when ``return_kv``.
    """
    q = _project_q(cfg, params, x)
    k, v = _project_kv(cfg, params, x if memory is None else memory)
    if angles is not None and memory is None:
        q = apply_rotary(q, angles)
        k = apply_rotary(k, angles)
    self_causal = causal and memory is None
    S = x.shape[1]
    if cfg.use_pallas and self_causal:
        out = flash_ops.flash_attention(q, k, v, causal=True, window=cfg.sliding_window,
                                        softcap=cfg.logit_softcap)
    elif self_causal and cfg.attn_chunk is not None and S > cfg.attn_chunk:
        out = chunked_sdpa(cfg, q, k, v, chunk=cfg.attn_chunk)
    else:
        mask = (causal_mask(S, S, window=cfg.sliding_window, device=x.device)
                if self_causal else None)
        out = sdpa(cfg, q, k, v, mask)
    B = x.shape[0]
    out = out.reshape(B, S, cfg.n_heads * cfg.resolved_head_dim) @ params["wo"]
    if return_kv:
        return out, (k, v)
    return out


# ---------------------------------------------------------------------------
# KV-cache decode
# ---------------------------------------------------------------------------

def cache_capacity(cfg, seq_len: int) -> int:
    """Sliding-window configs bound the live KV by the window (a ring)."""
    if cfg.sliding_window is not None:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def seed_cache(cache: KVCache, k, v) -> KVCache:
    """Write prefill KV (already rotated) into cache slots [0, S).

    A prefill longer than the ring's capacity C keeps its last C positions,
    rolled so that position p lands in slot p % C, where later decode writes
    (slot = pos % C) overwrite the oldest entry (``attention.py:237-252``).
    In place: the JAX package's ``dynamic_update_slice`` returns a new cache.
    """
    C, S = cache.k.shape[1], k.shape[1]
    if S > C:
        k = torch.roll(k[:, -C:], S % C, dims=1)
        v = torch.roll(v[:, -C:], S % C, dims=1)
        S = C
    cache.k[:, :S] = k
    cache.v[:, :S] = v
    return cache


def decode_attention(cfg, params, x, angles, cache: KVCache, pos):
    """One-token decode: x (B, 1, D), pos (B,) int, one absolute position per row.

    Row b writes its new KV at slot ``pos[b] % C`` in place (the JAX package
    returns a new cache) and attends over slots ``j <= pos[b]``
    (``attention.py:269-274``): in a ring (pos >= C) every slot, which holds
    exactly the window's last C positions. Scores in f32, capped by
    ``cfg.logit_softcap``; probabilities cast to the cache dtype before the
    product with V (``attention.py:292-298``).
    Returns (out (B, 1, D), cache).
    """
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    C = cache.k.shape[1]
    q = _project_q(cfg, params, x)
    k, v = _project_kv(cfg, params, x)
    if angles is not None:
        q, k = apply_rotary(q, angles), apply_rotary(k, angles)
    rows = torch.arange(B, device=x.device)
    slot = torch.remainder(pos, C)
    cache.k[rows, slot] = k[:, 0].to(cache.k.dtype)
    cache.v[rows, slot] = v[:, 0].to(cache.v.dtype)
    valid = torch.arange(C, device=x.device)[None, :] <= pos[:, None]  # (B, C)
    nkv = cfg.n_kv_heads
    qg = q.reshape(B, 1, nkv, cfg.n_heads // nkv, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), cache.k.float()) * (hd ** -0.5)
    logits = _softcap(logits, cfg.logit_softcap)
    logits = logits.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(cache.v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, cache.v)
    return out.reshape(B, 1, cfg.n_heads * hd) @ params["wo"], cache


def cross_decode_attention(cfg, params, x, mem_kv: KVCache):
    """One decoder token's cross-attention over a fixed encoder memory
    (``attention.py:303-317``): x (B, 1, D), mem_kv (B, M, n_kv, hd), no
    mask; ``sdpa``'s arithmetic (no audio config sets a softcap, which the
    JAX function lacks). Returns out (B, 1, D)."""
    out = sdpa(cfg, _project_q(cfg, params, x), mem_kv.k, mem_kv.v, None)
    return out.reshape(x.shape[0], 1, cfg.n_heads * cfg.resolved_head_dim) @ params["wo"]
