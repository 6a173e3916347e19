"""Client-level differential privacy for NanoAdapter updates, DP-FedAvg
style (``repro.core.privacy``; McMahan et al. 2018).

Before upload the adapter DELTA is clipped to L2 norm ≤ C and isotropic
Gaussian noise σ·C·N(0, I) is added. The noise is drawn from a
``torch.Generator`` the caller seeds; the JAX package's ``jax.random``
draws cannot be reproduced, so ``add_gaussian_noise`` takes the standard
normal draws as a tree and a test can hand it the JAX draws.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.utils import tree_map, tree_sq_norm, tree_sub


def clip_by_global_norm(tree, max_norm: float):
    """-> tree scaled by min(1, C / (‖tree‖₂ + 1e-12))."""
    norm = torch.sqrt(tree_sq_norm(tree))
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_map(lambda x: x * scale.to(x.dtype), tree)


def standard_normal_like(gen, tree):
    """N(0, 1) draws in f32, one per element, leaf by leaf from ``gen``."""
    return tree_map(lambda x: torch.randn(x.shape, generator=gen, dtype=torch.float32,
                                          device=x.device), tree)


def add_gaussian_noise(tree, noise, stddev: float):
    """tree + stddev · noise, in each leaf's dtype."""
    return tree_map(lambda x, z: x + stddev * z.to(x.dtype), tree, noise)


def privatize_update(gen, adapters: Dict, global_ref: Dict, *, clip_norm: float,
                     noise_mult: float) -> Dict:
    """-> privatized θ_k for the merge."""
    delta = tree_sub(adapters, global_ref)
    delta = clip_by_global_norm(delta, clip_norm)
    if noise_mult > 0:
        delta = add_gaussian_noise(delta, standard_normal_like(gen, delta),
                                   noise_mult * clip_norm)
    return tree_map(torch.add, global_ref, delta)



def dp_sigma(epsilon: float, delta: float) -> float:
    """Single-release Gaussian-mechanism noise multiplier for (ε, δ)."""
    if epsilon <= 0:
        raise ValueError("epsilon must be > 0")
    return math.sqrt(2.0 * math.log(1.25 / delta)) / epsilon
