"""Public wrapper of the flash-attention kernel
(``repro.kernels.flash_attention.ops``).

A tensor on the CPU takes the plain version in ``ref.py``. A tensor on a CUDA
device launches the hand-written kernel of ``csrc/flash_attention.cu`` or
raises. ``flash_attention.launches`` counts kernel launches.

``flash_attention`` is differentiable in (q, k, v): ``FlashAttention`` saves
the forward's output and per-row logsumexp and runs the JAX package's
backward (``repro/kernels/flash_attention/ops.py::_fa_bwd``, plain jnp there)
as plain torch, ``ref.attention_bwd``, on either device. p is rebuilt from
the saved LSE, so a wrong LSE from the kernel gives wrong gradients. That
backward holds the whole (B, H, Sq, Sk) f32 score matrix: 4.7 MB a layer at
llava's 96 training positions and batch 4, but quadratic in the sequence;
a blockwise backward kernel is ROADMAP performance work.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ref

HEAD_DIMS = (32, 64, 128, 256)  # the instantiations in csrc/flash_attention.cu


def flash_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                    softcap: float = 0.0, return_lse: bool = False):
    """q (B, Sq, H, D); k, v (B, Sk, Hkv, D), H % Hkv == 0 -> (B, Sq, H, D).

    Query i has absolute position (Sk - Sq) + i. With ``return_lse`` also
    returns the per-row logsumexp (B, Sq, H) in f32 (not differentiable).
    Differentiable in (q, k, v).
    """
    out, lse = FlashAttention.apply(q, k, v, causal, window, float(softcap or 0.0))
    return (out, lse) if return_lse else out


flash_attention.launches = 0


class FlashAttention(torch.autograd.Function):
    """Forward through the kernel (or its plain version), backward from the LSE."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        out, lse = _forward(q, k, v, causal=causal, window=window, softcap=softcap)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = dict(causal=causal, window=window, softcap=softcap)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = ref.attention_bwd(q, k, v, out, lse, g, **ctx.args)
        return dq, dk, dv, None, None, None


def _forward(q, k, v, *, causal, window, softcap):
    """-> (out, lse): the plain version on the CPU, the kernel on a CUDA device."""
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, window=window, softcap=softcap,
                             return_lse=True)
    build.require_cuda("flash_attention", q, k, v)
    B, Sq, H, D = q.shape
    Bk, Sk, Hkv, Dk = k.shape
    if (Bk, Dk) != (B, D) or v.shape != k.shape or H % Hkv != 0:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not fit")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if q.dtype not in build.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    out = torch.empty_like(q)
    lse = torch.empty((B, Sq, H), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = build.library().repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            B, Sq, Sk, H, Hkv, D, int(causal), window or 0, float(softcap or 0.0),
            D ** -0.5, build.DTYPE_CODES[q.dtype], build.stream_of(q))
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out, lse
