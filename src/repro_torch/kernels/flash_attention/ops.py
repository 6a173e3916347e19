"""Public wrapper of the flash-attention kernel
(``repro.kernels.flash_attention.ops``).

A tensor on the CPU takes the plain version in ``ref.py``. A tensor on a CUDA
device launches the hand-written kernel of ``csrc/flash_attention.cu`` or
raises. ``flash_attention.launches`` counts kernel launches.

The backward (``_fa_bwd`` in the JAX package) comes with the training slice
(ROADMAP queue 1).
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
    returns the per-row logsumexp (B, Sq, H) in f32.
    """
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, window=window, softcap=softcap,
                             return_lse=return_lse)
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
    return (out, lse) if return_lse else out


flash_attention.launches = 0
