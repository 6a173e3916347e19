"""Plain PyTorch versions of the Fisher-merge kernels
(``repro.kernels.fisher_merge.ref``, paper Eq. 1, elementwise).

The CPU takes these, as does ``use_pallas=False`` on any device;
``chip_smoke.py`` holds the CUDA kernels against them on the card. Sums in f32.
"""
from __future__ import annotations

import torch


def fisher_merge(theta, fisher, weights, *, eps: float = 1e-8):
    """theta/fisher (K, ...); weights (K,) -> merged (...) in theta's dtype.

    out = Σ_k w_k F_k θ_k / (Σ_k w_k F_k + eps)
    """
    t, f = theta.float(), fisher.float()
    wf = weights.float().reshape((-1,) + (1,) * (theta.dim() - 1)) * f
    num = (wf * t).sum(dim=0)
    den = wf.sum(dim=0)
    return (num / (den + eps)).to(theta.dtype)


def fisher_fold(num, den, theta, fisher, w: float):
    """Fold one client's (θ, F, w) into the running f32 sums, in place:
    num += w·F·θ, den += w·F. Returns (num, den).

    Folding every client and then ``num / (den + eps)`` reproduces
    :func:`fisher_merge` up to f32 summation order.
    """
    wf = torch.tensor(w, dtype=torch.float32) * fisher.float()
    num += wf * theta.float()
    den += wf
    return num, den
