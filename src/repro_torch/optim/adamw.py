"""AdamW (decoupled weight decay) over a tree of tensors
(``repro.optim.adamw``, ported as it is rather than ``torch.optim.AdamW``, so
its arithmetic, and the global-norm clip in f32, follow the JAX package's to
rounding, and its state is a plain tree a checkpoint can hold)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.utils import tree_leaves, tree_map, tree_zeros_like


class AdamWState(NamedTuple):
    mu: dict
    nu: dict
    step: torch.Tensor  # () int32, on the params' device


def adamw_init(params) -> AdamWState:
    device = tree_leaves(params)[0].device
    return AdamWState(mu=tree_zeros_like(params), nu=tree_zeros_like(params),
                      step=torch.zeros((), dtype=torch.int32, device=device))


def adamw_update(grads, state: AdamWState, params, *, lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
                 grad_clip: float = 0.0):
    """-> (new params, new state). Pure: nothing is updated in place."""
    step = state.step + 1
    if grad_clip and grad_clip > 0.0:
        gsq = sum(g.float().square().sum() for g in tree_leaves(grads))
        scale = torch.clamp(grad_clip / (torch.sqrt(gsq) + 1e-9), max=1.0)
        grads = tree_map(lambda g: g * scale.to(g.dtype), grads)

    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
    nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g.square(), state.nu, grads)
    stepf = step.float()
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=stepf.device), stepf)

    def upd(p, m, v):
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay:
            delta = delta + weight_decay * p
        return (p - lr * delta).to(p.dtype)

    return tree_map(upd, params, mu, nu), AdamWState(mu=mu, nu=nu, step=step)
