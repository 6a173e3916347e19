"""Server-side Fisher merge (paper §3.4, Eq. 1; ``repro.core.aggregation``).

Laplace-posterior merging with diagonal FIM precision, weighted by client
data share p_k = |D_k| / Σ|D_j|:

    θ_global = ( Σ_k p_k F_k θ_k ) / ( Σ_k p_k F_k + eps )     (elementwise)

``use_pallas`` routes each leaf through the hand-written ``fisher_merge``
kernel (its plain version on the CPU); without it each leaf takes the plain
version wherever it lies. FedAvg and the other strategies'
aggregations arrive with them (ROADMAP queue 2).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels.fisher_merge import ops as fm_ops
from repro_torch.kernels.fisher_merge import ref as fm_ref
from repro_torch.utils import tree_leaves, tree_map


def _norm_weights(sizes: Optional[Sequence[float]], n: int, device) -> torch.Tensor:
    """(n,) f32 data shares; uniform for ``None`` or an all-zero cohort.

    Computed on the host in f32, as the JAX package computes them on its
    device: the sizes are small integers, so the sum is exact either way.
    """
    if sizes is None:
        w = np.ones((n,), np.float32) / np.float32(n)
    else:
        w = np.asarray(sizes, np.float32)
        total = w.sum(dtype=np.float32)
        w = w / total if total > 0 else np.ones_like(w) / np.float32(n)
    return torch.from_numpy(w.astype(np.float32)).to(device)


def _tree_stack(trees: List):
    return tree_map(lambda *leaves: torch.stack(leaves), trees[0], *trees[1:])


def fisher_merge(thetas: List, fishers: List, data_sizes: Optional[Sequence[float]] = None,
                 *, eps: float = 1e-8, use_pallas: bool = False):
    """Eq. 1: elementwise Fisher-weighted merge over K clients."""
    k = len(thetas)
    if len(fishers) != k:
        raise ValueError(f"fisher_merge: {k} thetas but {len(fishers)} fishers")
    ts, fs = _tree_stack(thetas), _tree_stack(fishers)   # leaves (K, ...)
    w = _norm_weights(data_sizes, k, tree_leaves(ts)[0].device)

    merge = fm_ops.fisher_merge if use_pallas else fm_ref.fisher_merge
    return tree_map(lambda t, f: merge(t, f, w, eps=eps), ts, fs)
