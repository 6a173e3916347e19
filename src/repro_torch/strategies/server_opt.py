"""Server-side optimizers over the round pseudo-gradient, the FedOpt family
(``repro.strategies.server_opt``).

After ``Strategy.aggregate`` the engine treats Δ = merged − θ_global as a
gradient estimate and lets a ``ServerOpt`` take the step (Reddi et al. 2021):

    θ_global ← ServerOpt(θ_global, Δ)

``None`` is the identity (θ_global ← merged), the paper's Alg. 1. A
``ServerOpt`` is a stateless frozen dataclass; its moments are a tree
threaded through ``apply``. ``FedBuffOpt`` is the buffered engine's damped
step.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.utils import tree_map, tree_sub, tree_zeros_like


@dataclass(frozen=True)
class ServerOpt:
    """Identity server step."""

    def init(self, params):
        return None

    def apply(self, opt_state, global_params, merged):
        """-> (new global params, new opt state)."""
        return merged, opt_state


@dataclass(frozen=True)
class FedBuffOpt(ServerOpt):
    """Damped server step for buffered asynchronous merging (FedBuff, Nguyen
    et al. 2022): θ ← θ + lr·Δ. The identity at lr = 1; lr < 1 tempers
    merges built from stale buffered uploads."""

    lr: float = 1.0

    def apply(self, s, global_params, merged):
        return tree_map(lambda g, m: g + self.lr * (m - g), global_params, merged), s


@dataclass(frozen=True)
class FedAvgMOpt(ServerOpt):
    """Server momentum: m ← β·m + Δ;  θ ← θ + lr·m (Hsu et al. 2019)."""

    lr: float = 1.0
    beta: float = 0.9

    def init(self, params):
        return tree_zeros_like(params)

    def apply(self, m, global_params, merged):
        delta = tree_sub(merged, global_params)
        m = tree_map(lambda mm, d: self.beta * mm + d, m, delta)
        return tree_map(lambda g, mm: g + self.lr * mm, global_params, m), m


@dataclass(frozen=True)
class FedAdamOpt(ServerOpt):
    """FedAdam: Adam moments over Δ, no bias correction (as in the FedOpt
    paper); ``eps`` is the adaptivity floor τ."""

    lr: float = 0.1
    b1: float = 0.9
    b2: float = 0.99
    eps: float = 1e-3

    def init(self, params):
        return {"m": tree_zeros_like(params), "v": tree_zeros_like(params)}

    def apply(self, s, global_params, merged):
        delta = tree_sub(merged, global_params)
        m = tree_map(lambda mm, d: self.b1 * mm + (1.0 - self.b1) * d, s["m"], delta)
        v = tree_map(lambda vv, d: self.b2 * vv + (1.0 - self.b2) * torch.square(d),
                     s["v"], delta)
        new = tree_map(lambda g, mm, vv: g + self.lr * mm / (torch.sqrt(vv) + self.eps),
                       global_params, m, v)
        return new, {"m": m, "v": v}
