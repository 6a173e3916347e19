"""Server-side aggregation (paper §3.4, Eq. 1; ``repro.core.aggregation``).

``fisher_merge`` is the paper's: Laplace-posterior merging with diagonal FIM
precision, weighted by client data share p_k = |D_k| / Σ|D_j|:

    θ_global = ( Σ_k p_k F_k θ_k ) / ( Σ_k p_k F_k + eps )     (elementwise)

``use_pallas`` hands the K clients' leaves, where they lie, to the
hand-written ``fisher_merge`` kernel: one launch for the whole tree (the
plain version on the CPU); without it each leaf takes the plain version
wherever it lies. ``fedavg`` is the isotropic case (F_k ≡ 1), the merge of
FedAvg, FedProx and FedDPA-F's shared adapter: a weighted sum the JAX
package leaves to XLA, so plain torch here. ``aggregate`` routes a strategy's name to its merge.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from repro_torch.kernels.fisher_merge import ops as fm_ops
from repro_torch.kernels.fisher_merge import ref as fm_ref
from repro_torch.utils import tree_leaves, tree_unflatten


def _norm_weights(sizes: Optional[Sequence[float]], n: int) -> np.ndarray:
    """(n,) f32 data shares on the host; uniform for ``None`` or an all-zero
    cohort.

    Computed in f32, as the JAX package computes them on its device: the
    sizes are small integers, so the sum is exact either way.
    """
    if sizes is None:
        return np.ones((n,), np.float32) / np.float32(n)
    w = np.asarray(sizes, np.float32)
    total = w.sum(dtype=np.float32)
    return (w / total if total > 0 else np.ones_like(w) / np.float32(n)).astype(np.float32)


def fedavg(thetas: List, data_sizes: Optional[Sequence[float]] = None):
    """Data-size-weighted parameter average (McMahan et al. 2017): Σ_k p_k θ_k
    in each leaf's dtype, summed in client order."""
    w = _norm_weights(data_sizes, len(thetas))

    def mean(*leaves):
        out = leaves[0] * float(w[0])
        for x, wk in zip(leaves[1:], w[1:]):
            out = out.add_(x, alpha=float(wk))
        return out

    return tree_unflatten(thetas[0], [mean(*ls) for ls in zip(*map(tree_leaves, thetas))])


def fisher_merge(thetas: List, fishers: List, data_sizes: Optional[Sequence[float]] = None,
                 *, eps: float = 1e-8, use_pallas: bool = False):
    """Eq. 1: elementwise Fisher-weighted merge over K clients."""
    k = len(thetas)
    if len(fishers) != k:
        raise ValueError(f"fisher_merge: {k} thetas but {len(fishers)} fishers")
    merge = fm_ops.fisher_merge_leaves if use_pallas else fm_ref.fisher_merge_leaves
    merged = merge([tree_leaves(t) for t in thetas], [tree_leaves(f) for f in fishers],
                   _norm_weights(data_sizes, k), eps=eps)
    return tree_unflatten(thetas[0], merged)


STRATEGIES = ("fednano", "fednano_ef", "fedavg", "fedprox", "feddpa_f", "locft")


def aggregate(strategy: str, thetas, fishers, data_sizes, *, use_pallas: bool = False):
    if strategy in ("fednano", "fednano_ef"):
        return fisher_merge(thetas, fishers, data_sizes, use_pallas=use_pallas)
    if strategy in ("fedavg", "fedprox", "feddpa_f"):
        return fedavg(thetas, data_sizes)
    if strategy == "locft":
        return None  # no aggregation: clients stay local
    raise ValueError(f"unknown strategy {strategy!r}")
