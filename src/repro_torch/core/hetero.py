"""Heterogeneous NanoAdapter ranks across clients (``repro.core.hetero``).

Addresses the paper's first stated limitation (clients with different
hardware): client k trains rank-r_k adapters (r_k ≤ R_max), and the server
merges in the rank-R_max space. Zero-padding is exact for LoRA: a rank-r
pair (down D×r, up r×D) padded to R computes the same function at the same
scale (the padded rows of ``up`` are zero, so the padded columns of
``down`` are inert), and its diagonal Fisher is zero on the padding, so the
Fisher merge gives those coordinates zero weight for that client; where no
client has mass the merge is 0/(0 + eps) = 0. Each client downloads the
merged adapters truncated back to its own rank (the leading sub-pair).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.aggregation import fisher_merge
from repro_torch.utils import tree_map


def pad_adapter(adapter: Dict, rank_max: int) -> Dict:
    """{'down': (D, r), 'up': (r, D)} -> the rank_max-padded pair (same function)."""
    down, up = adapter["down"], adapter["up"]
    r = down.shape[1]
    if r == rank_max:
        return adapter
    assert r < rank_max, (r, rank_max)
    pad = rank_max - r
    return {"down": F.pad(down, (0, pad)), "up": F.pad(up, (0, 0, 0, pad))}


def truncate_adapter(adapter: Dict, rank: int) -> Dict:
    return {"down": adapter["down"][:, :rank], "up": adapter["up"][:rank, :]}


def pad_nanoedge(adapters: Dict, rank_max: int) -> Dict:
    return {mod: pad_adapter(a, rank_max) for mod, a in adapters.items()}


def truncate_nanoedge(adapters: Dict, rank: int) -> Dict:
    return {mod: truncate_adapter(a, rank) for mod, a in adapters.items()}


def hetero_fisher_merge(thetas: List[Dict], fishers: List[Optional[Dict]], ranks: Sequence[int],
                        data_sizes: Optional[Sequence[float]] = None, *,
                        rank_max: Optional[int] = None):
    """Fisher-merge rank-heterogeneous NanoEdge updates in rank-R_max space
    (default the largest rank) -> the merged rank-R_max NanoEdge. A client's
    Fisher may be None: ones on its live coordinates, still zero on the
    padding."""
    rmax = rank_max or max(ranks)
    padded_t, padded_f = [], []
    for theta, fisher, _ in zip(thetas, fishers, ranks):
        padded_t.append(pad_nanoedge(theta, rmax))
        if fisher is None:
            fisher = tree_map(torch.ones_like, theta)
        padded_f.append(pad_nanoedge(fisher, rmax))
    return fisher_merge(padded_t, padded_f, data_sizes)
