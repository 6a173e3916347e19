"""Plain PyTorch versions of the Fisher-merge kernels
(``repro.kernels.fisher_merge.ref``, paper Eq. 1, elementwise).

The CPU takes these, as does ``use_pallas=False`` on any device;
``chip_smoke.py`` holds the CUDA kernels against them on the card. Sums in
f32, over the clients in order k = 0..K-1 as the kernels sum, so an f32
result has the kernels' bits. Weights are host floats: a sequence, numpy or
a tensor.
"""
from __future__ import annotations

import numpy as np
import torch


def host_weights(weights) -> np.ndarray:
    """The weights as a flat float32 numpy array."""
    if isinstance(weights, torch.Tensor):
        weights = weights.detach().float().cpu().numpy()
    return np.asarray(weights, dtype=np.float32).reshape(-1)


def _merge(thetas, fishers, w: np.ndarray, eps: float):
    """One leaf from its K client tensors: Σ_k w_k F_k θ_k / (Σ_k w_k F_k + eps)."""
    num = torch.zeros(thetas[0].shape, dtype=torch.float32, device=thetas[0].device)
    den = torch.zeros_like(num)
    for wk, t, f in zip(w.tolist(), thetas, fishers):
        wf = f.float() * wk
        num = num + wf * t.float()
        den = den + wf
    return (num / (den + eps)).to(thetas[0].dtype)


def fisher_merge(theta, fisher, weights, *, eps: float = 1e-8):
    """theta/fisher (K, ...); weights (K,) -> merged (...) in theta's dtype.

    out = Σ_k w_k F_k θ_k / (Σ_k w_k F_k + eps)
    """
    return _merge(theta.unbind(0), fisher.unbind(0), host_weights(weights), eps)


def fisher_merge_leaves(thetas, fishers, weights, *, eps: float = 1e-8):
    """thetas[k] / fishers[k]: client k's list of L leaves; weights (K,).
    -> the L merged leaves, leaf by leaf."""
    w = host_weights(weights)
    return [_merge([t[l] for t in thetas], [f[l] for f in fishers], w, eps)
            for l in range(len(thetas[0]))]


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


def fisher_finalize(num, den, *, eps: float = 1e-8, dtype=torch.float32):
    """num / (den + eps) with the accumulators' f32 carried to the end."""
    return (num / (den + eps)).to(dtype)


def fisher_fold_leaves(nums, dens, thetas, fishers, w: float):
    """Fold one upload's L leaves into the running sums, in place, leaf by
    leaf. Returns (nums, dens)."""
    for num, den, theta, fisher in zip(nums, dens, thetas, fishers):
        fisher_fold(num, den, theta, fisher, w)
    return nums, dens
