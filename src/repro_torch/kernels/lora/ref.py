"""Plain PyTorch versions of the LoRA kernels (``repro.kernels.lora.ref``).

The CPU takes these; ``chip_smoke.py`` holds the CUDA kernels against them
on the card. Math in f32, one cast to x's dtype at the end.
"""
from __future__ import annotations

import torch


def lora_residual(x, down, up, *, scale: float):
    """y = x + scale · (x @ down) @ up.  x (..., D); down (D, r); up (r, D)."""
    xf = x.float()
    y = (xf @ down.float()) @ up.float()
    return (xf + scale * y).to(x.dtype)


def grouped_lora_residual(x, down, up, idx, *, scale: float):
    """Per-row adapter selection against a stacked bank.

    x (..., D); down (N, D, r); up (N, r, D); idx (...) integer adapter id
    of each row. A row whose id lies outside [0, N) comes back as x, bit for
    bit (the identity slot), as in the Pallas kernel and the CUDA kernel.
    """
    n = down.shape[0]
    live = ((idx >= 0) & (idx < n))[..., None]
    safe = idx.clamp(0, n - 1).long()
    xf = x.float()
    h = torch.einsum("...d,...dr->...r", xf, down[safe].float())
    y = torch.einsum("...r,...rd->...d", h, up[safe].float())
    return torch.where(live, (xf + scale * y).to(x.dtype), x)


def tf32_round(t):
    """f32 rounded to nearest at TF32's 10 mantissa bits, ties away from zero
    (``cvt.rna.tf32.f32``): add half of the dropped 13 bits' weight to the
    magnitude, then clear them."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(t):
    """t = hi + lo to about 2^-22 relative, both exact in TF32."""
    hi = tf32_round(t)
    return hi, tf32_round(t.float() - hi)


def lora_residual_split_tf32(x, down, up, *, scale: float):
    """Plain model of the bf16 kernel's arithmetic (``csrc/lora.cu``,
    namespace tc): x·A = x·A_hi + x·A_lo and h·B = h_hi·B_hi + h_hi·B_lo +
    h_lo·B_hi in f32, the residual in f32, one cast to x's dtype. x must be
    exact in TF32, as bf16 values are. Only the tests and ``chip_smoke.py``
    use it.
    """
    xf = x.float()
    a_hi, a_lo = split_tf32(down)
    h = xf @ a_hi + xf @ a_lo
    h_hi, h_lo = split_tf32(h)
    b_hi, b_lo = split_tf32(up)
    y = h_hi @ b_hi + h_hi @ b_lo + h_lo @ b_hi
    return (xf + scale * y).to(x.dtype)


def lora_residual_tf32(x, down, up, *, scale: float):
    """Single-pass TF32 (A, h and B each rounded once to TF32), which the bf16
    kernel does not use. The tests and ``chip_smoke.py`` hold it against
    ``lora_residual_split_tf32`` to show that ``harness.LORA_MODEL_MAX_SHARE``
    tells the two apart."""
    xf = x.float()
    h = xf @ tf32_round(down)
    y = tf32_round(h) @ tf32_round(up)
    return (xf + scale * y).to(x.dtype)
