"""Plain PyTorch version of the flash-attention kernel.

Computes the kernel's function (``repro.kernels.flash_attention``): f32
scores and probabilities, the per-row logsumexp, and 0 output with
lse = NEG_INF for a row that sees no key (the kernel's guard; the JAX jnp
oracle has no such rows at the shapes it is run at).
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.0e38


def attention_mask(sq: int, sk: int, *, causal: bool, window: Optional[int], device):
    """(Sq, Sk) bool, True = attend; query i sits at position (Sk - Sq) + i."""
    qpos = torch.arange(sq, device=device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (qpos - kpos < window)
    return mask


def attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
              softcap: float = 0.0, return_lse: bool = False):
    """q (B, Sq, H, D); k, v (B, Sk, Hkv, D), H % Hkv == 0 -> (B, Sq, H, D).

    With ``return_lse`` also returns the logsumexp (B, Sq, H) in f32.
    """
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(H // Hkv, dim=2)
    vf = v.float().repeat_interleave(H // Hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * (D ** -0.5)
    if softcap and softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    mask = attention_mask(Sq, Sk, causal=causal, window=window, device=q.device)
    s = s.masked_fill(~mask, NEG_INF)
    live = mask.any(dim=-1)[:, None]                       # (Sq, 1)
    probs = torch.where(live, torch.softmax(s, dim=-1), 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vf).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(live[:, 0], torch.logsumexp(s, dim=-1), NEG_INF)
    return out, lse.permute(0, 2, 1).contiguous()
