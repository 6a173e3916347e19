"""Diagonal Fisher information for NanoAdapter params (paper §3.4;
``repro.core.fisher``).

    F ≈ E_{(v,q,a)~D_k} [ (∇_θ log p(a|v,q,θ))² ]

FedNano's dedicated pass (``fisher_pass``) runs an extra forward and
backward per batch on local data at the final local params and averages the
squared gradients. The streaming estimator of FedNano-EF arrives with that
strategy (ROADMAP queue 2).
"""
from __future__ import annotations

from typing import Callable, Iterable, NamedTuple

import torch

from repro_torch.utils import tree_map, tree_zeros_like


class FisherAccumulator(NamedTuple):
    sum_sq: dict          # Σ grad², adapter structure, f32
    count: float          # gradient evaluations accumulated

    @staticmethod
    def init(adapters) -> "FisherAccumulator":
        return FisherAccumulator(sum_sq=tree_zeros_like(adapters, dtype=torch.float32),
                                 count=0.0)

    def update(self, grads) -> "FisherAccumulator":
        new = tree_map(lambda s, g: s + g.to(s.dtype).square(), self.sum_sq, grads)
        return FisherAccumulator(sum_sq=new, count=self.count + 1.0)

    def finalize(self, eps: float = 1e-8):
        """Mean squared gradient (diagonal FIM estimate)."""
        c = max(self.count, 1.0)
        return tree_map(lambda s: s / c + eps, self.sum_sq)


def fisher_pass(grad_fn: Callable, adapters, batches: Iterable, *, eps: float = 1e-8):
    """Dedicated FIM pass: mean over batches of grad(loss)² at fixed params.

    grad_fn(adapters, batch) -> grads tree (same structure as adapters).
    """
    acc = FisherAccumulator.init(adapters)
    for batch in batches:
        acc = acc.update(grad_fn(adapters, batch))
    return acc.finalize(eps=eps)
