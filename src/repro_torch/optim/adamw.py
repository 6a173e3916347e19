"""AdamW (decoupled weight decay) over a tree of tensors
(``repro.optim.adamw``, ported as it is rather than ``torch.optim.AdamW``, so
its arithmetic, and the global-norm clip in f32, follow the JAX package's to
rounding, and its state is a plain tree a checkpoint can hold).

``adamw_update_many`` is the update of K clients stacked along a leading
axis, which JAX gets from ``vmap``: each row clips by its own norm and takes
its own bias correction, so row k equals ``adamw_update`` on client k.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.utils import tree_leaves, tree_map, tree_zeros_like


class AdamWState(NamedTuple):
    mu: dict
    nu: dict
    step: torch.Tensor  # () int32 (stacked: (K,)), on the params' device


def adamw_init(params) -> AdamWState:
    device = tree_leaves(params)[0].device
    return AdamWState(mu=tree_zeros_like(params), nu=tree_zeros_like(params),
                      step=torch.zeros((), dtype=torch.int32, device=device))


def _rows(v, like):
    """A per-row (K,) value shaped to broadcast over ``like`` (K, ...); a 0-d
    value as it is."""
    return v.reshape(v.shape + (1,) * (like.dim() - v.dim()))


def _update(grads, state: AdamWState, params, *, lr, b1, b2, eps, weight_decay, grad_clip,
            sq_sum):
    step = state.step + 1
    if grad_clip and grad_clip > 0.0:
        gsq = sum(sq_sum(g.float().square()) for g in tree_leaves(grads))
        scale = torch.clamp(grad_clip / (torch.sqrt(gsq) + 1e-9), max=1.0)
        grads = tree_map(lambda g: g * _rows(scale, g).to(g.dtype), grads)

    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
    nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g.square(), state.nu, grads)
    stepf = step.float()
    # the bases made on the device (a copy from the host waits for the card)
    bc1 = 1 - torch.pow(torch.full((), b1, dtype=torch.float32, device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.full((), b2, dtype=torch.float32, device=stepf.device), stepf)

    def upd(p, m, v):
        delta = (m / _rows(bc1, m)) / (torch.sqrt(v / _rows(bc2, v)) + eps)
        if weight_decay:
            delta = delta + weight_decay * p
        return (p - lr * delta).to(p.dtype)

    return tree_map(upd, params, mu, nu), AdamWState(mu=mu, nu=nu, step=step)


def adamw_update(grads, state: AdamWState, params, *, lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
                 grad_clip: float = 0.0):
    """-> (new params, new state). Pure: nothing is updated in place."""
    return _update(grads, state, params, lr=lr, b1=b1, b2=b2, eps=eps,
                   weight_decay=weight_decay, grad_clip=grad_clip, sq_sum=torch.sum)


def adamw_update_many(grads, state: AdamWState, params, *, lr: float, b1: float = 0.9,
                      b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
                      grad_clip: float = 0.0):
    """:func:`adamw_update` of K clients stacked on axis 0 of every leaf,
    ``state.step`` (K,): the global-norm clip takes one norm per row (each
    leaf summed over all but its first axis, then across leaves) and the bias
    correction each row's own step, so clients never mix."""
    return _update(grads, state, params, lr=lr, b1=b1, b2=b2, eps=eps,
                   weight_decay=weight_decay, grad_clip=grad_clip,
                   sq_sum=lambda t: t.flatten(1).sum(1))
