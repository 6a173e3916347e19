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
