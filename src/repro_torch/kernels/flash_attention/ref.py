"""Plain PyTorch version of the flash-attention kernel.

Computes the kernel's function (``repro.kernels.flash_attention``): f32
scores and probabilities, the per-row logsumexp, and 0 output with
lse = NEG_INF for a row that sees no key (the kernel's guard; the JAX jnp
oracle has no such rows at the shapes it is run at).

``attention_bwd`` is the plain backward from the saved LSE (the JAX
package's ``_fa_bwd``): the CPU's, and f32's on the card; bf16 on the card
runs the backward kernel, whose rounding ``attention_bwd_bf16_model``
models.
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


def attention_bf16_model(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                         softcap: float = 0.0, return_lse: bool = False):
    """Plain model of the bf16 kernel's rounding (``csrc/flash_attention.cu``,
    ``flash_fwd_bf16``): f32 scores, p = exp(s - m) in f32, P rounded to bf16
    before the product with V, the normaliser l and the LSE summed from the
    f32 p. Same arguments and result as ``attention``. Only the tests and
    ``chip_smoke.py`` use it; the kernel rounds P against its running max,
    this model against the row's final max.
    """
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(H // Hkv, dim=2)
    vf = v.float().repeat_interleave(H // Hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * (D ** -0.5)
    if softcap and softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    mask = attention_mask(Sq, Sk, causal=causal, window=window, device=q.device)
    live = mask.any(dim=-1)                                # (Sq,)
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask & live[:, None], torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(torch.bfloat16).float(), vf)
    out = (pv / l.clamp_min(1e-30).permute(0, 2, 1, 3)).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(live, (m + torch.log(l)).squeeze(-1), NEG_INF)
    return out, lse.permute(0, 2, 1).contiguous()


def attention_bwd(q, k, v, out, lse, g, *, causal: bool, window: Optional[int],
                  softcap: float):
    """(dq, dk, dv) of ``attention`` from its output and logsumexp
    (``repro/kernels/flash_attention/ops.py::_fa_bwd``).

    p = exp(s - L) from the saved LSE; rows whose LSE carries the NEG_INF
    marker see no key and get p = 0; the D-trick ds = p ∘ (g·vᵀ - rowsum(g ∘ o));
    the softcap chain factor (1 - tanh²); GQA K/V grads summed over each
    head group. f32 inside, grads in the input dtypes.
    """
    return _attention_bwd(q, k, v, out, lse, g, causal=causal, window=window,
                          softcap=softcap, p_operand=_exact, ds_operand=_exact)


def attention_bwd_bf16_model(q, k, v, out, lse, g, *, causal: bool, window: Optional[int],
                             softcap: float):
    """Plain model of the bf16 backward kernel's rounding
    (``csrc/flash_attention_bwd.cu``): ``attention_bwd`` with p rounded to
    bf16 before dv = pᵀ·g, and ds as hi + lo, two bf16 halves
    (hi = bf16(ds), lo = bf16(ds - hi)), before dq = ds·k and dk = dsᵀ·q;
    the scores, p, the row term, ds and every sum stay f32. Same arguments
    and result. Only the tests and ``chip_smoke.py`` use it.
    """
    return _attention_bwd(q, k, v, out, lse, g, causal=causal, window=window,
                          softcap=softcap, p_operand=_bf16, ds_operand=_bf16_hi_lo)


def _exact(x):
    return x


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _bf16_hi_lo(x):
    hi = _bf16(x)
    return hi + _bf16(x - hi)


def _attention_bwd(q, k, v, out, lse, g, *, causal, window, softcap, p_operand, ds_operand):
    """The backward, with ``p_operand`` and ``ds_operand`` applied to p and
    ds where they enter their products."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    qf = q.float()
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    gf, of = g.float(), out.float()
    scale = D ** -0.5

    u = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    dfac = None
    if softcap and softcap > 0.0:
        t = torch.tanh(u / softcap)
        s = t * softcap
        dfac = 1.0 - t * t
    else:
        s = u
    mask = attention_mask(Sq, Sk, causal=causal, window=window, device=q.device)
    lse_h = lse.permute(0, 2, 1)                                  # (B, H, Sq)
    live = (lse_h > NEG_INF / 2)[..., None]                       # (B, H, Sq, 1)
    p = torch.where(mask & live, torch.exp(s - lse_h[..., None]), 0.0)

    dv = torch.einsum("bhqk,bqhd->bkhd", p_operand(p), gf)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    drow = (gf * of).sum(dim=-1).permute(0, 2, 1)                 # (B, H, Sq)
    ds = p * (dp - drow[..., None])
    if dfac is not None:
        ds = ds * dfac
    ds = ds_operand(ds)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    if group > 1:
        dk = dk.reshape(B, Sk, Hkv, group, D).sum(dim=3)
        dv = dv.reshape(B, Sk, Hkv, group, D).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
