"""Partial participation: which clients run each round
(``repro.strategies.sampling``).

The engine asks a ``ClientSampler`` for the round's cohort. The default
(full participation) is the paper's setting and draws nothing. Samplers are
stateless: a round's cohort is a pure function of (seed, round index),
drawn from a ``torch.Generator`` seeded by ``round_seed``, with no state
carried from round to round, so a resumed run replays round r's cohort. The
JAX package draws with ``jax.random.choice`` over ``fold_in(PRNGKey(seed),
round)``, which torch cannot reproduce: the port keeps the contract (the
cohort sizes, sorted cohorts, the same cohort for the same (seed, round)),
not the draws.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch


def round_seed(seed: int, round_idx: int) -> int:
    """The seed of round ``round_idx``'s draws: a 64-bit mix of (seed, round)
    (numpy's ``SeedSequence``), the port's counterpart of the JAX package's
    ``round_key``."""
    return int(np.random.SeedSequence([seed, round_idx]).generate_state(1, np.uint64)[0])


def _draw(seed: int, round_idx: int, cids: Sequence[int], n: int) -> List[int]:
    """``n`` of ``cids`` without replacement, sorted."""
    gen = torch.Generator().manual_seed(round_seed(seed, round_idx))
    idx = torch.randperm(len(cids), generator=gen)[:n]
    return sorted(cids[int(i)] for i in idx)


@dataclass(frozen=True)
class ClientSampler:
    """Full participation: every client, every round."""

    def select(self, round_idx: int, cids: Sequence[int]) -> List[int]:
        return list(cids)


@dataclass(frozen=True)
class UniformSampler(ClientSampler):
    """Sample max(1, round(frac·K)) clients uniformly without replacement."""

    frac: float = 0.5
    seed: int = 0

    def select(self, round_idx: int, cids: Sequence[int]) -> List[int]:
        k = len(cids)
        return _draw(self.seed, round_idx, cids, min(k, max(1, int(round(self.frac * k)))))


@dataclass(frozen=True)
class FixedSizeSampler(ClientSampler):
    """A cohort of exactly min(max(1, n), K) clients per round."""

    n: int = 1
    seed: int = 0

    def select(self, round_idx: int, cids: Sequence[int]) -> List[int]:
        k = len(cids)
        n = min(max(1, self.n), k)
        if n == k:
            return list(cids)
        return _draw(self.seed, round_idx, cids, n)
