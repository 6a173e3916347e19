"""Dirichlet non-IID partitioning (paper §4.1; Che et al. 2023; Lai et al. 2022);
the port's numpy copy of ``repro.data.partition``.

For each topic (ScienceQA topic / IconQA skill analogue), sample a
distribution over the K clients from Dir(α·1_K) and split that topic's
examples proportionally. Small α ⇒ each topic concentrates on few clients
(strongly non-IID); large α ⇒ near-uniform (near-IID). The paper uses
α ∈ {0.1, 1, 5} with α=1 as the main setting.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def dirichlet_partition(
    items: Sequence,
    topics: Sequence[int],
    n_clients: int,
    alpha: float,
    seed: int = 0,
    min_per_client: int = 2,
) -> Dict[int, List]:
    """Partition ``items`` (with per-item topic labels) across clients."""
    rng = np.random.RandomState(seed)
    topics = np.asarray(topics)
    uniq = np.unique(topics)
    shards: Dict[int, List] = {k: [] for k in range(n_clients)}

    for t in uniq:
        idx = np.where(topics == t)[0]
        rng.shuffle(idx)
        p = rng.dirichlet(alpha * np.ones(n_clients))
        # proportional contiguous split
        counts = np.floor(p * len(idx)).astype(int)
        while counts.sum() < len(idx):
            counts[rng.randint(n_clients)] += 1
        start = 0
        for k in range(n_clients):
            for i in idx[start : start + counts[k]]:
                shards[k].append(items[i])
            start += counts[k]

    # guarantee a floor so every client can form at least one batch
    donors = sorted(shards, key=lambda k: -len(shards[k]))
    for k in range(n_clients):
        while len(shards[k]) < min_per_client:
            d = donors[0]
            if len(shards[d]) <= min_per_client:
                break
            shards[k].append(shards[d].pop())
            donors = sorted(shards, key=lambda q: -len(shards[q]))
    for k in shards:
        rng.shuffle(shards[k])
    return shards


def partition_stats(shards: Dict[int, List], topic_of) -> Dict[int, Dict[int, int]]:
    """client -> topic -> count (for heterogeneity reporting)."""
    out = {}
    for k, items in shards.items():
        hist: Dict[int, int] = {}
        for it in items:
            t = topic_of(it)
            hist[t] = hist.get(t, 0) + 1
        out[k] = hist
    return out
