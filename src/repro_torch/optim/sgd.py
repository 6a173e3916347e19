"""SGD with optional momentum over a tree of tensors (``repro.optim.sgd``)."""
from __future__ import annotations

from typing import NamedTuple

from repro_torch.utils import tree_map, tree_zeros_like


class SGDState(NamedTuple):
    velocity: dict


def sgd_init(params) -> SGDState:
    return SGDState(velocity=tree_zeros_like(params))


def sgd_update(grads, state: SGDState, params, *, lr: float, momentum: float = 0.0):
    """-> (new params, new state); without momentum the velocity is kept as
    it was. Each new parameter is cast back to the parameter's dtype."""
    if momentum:
        vel = tree_map(lambda v, g: momentum * v + g, state.velocity, grads)
    else:
        vel = grads
    new_params = tree_map(lambda p, v: (p - lr * v).to(p.dtype), params, vel)
    return new_params, SGDState(velocity=vel if momentum else state.velocity)
