"""Client failure injection: dropout, mid-update crashes, stragglers
(``repro.core.failures``).

Cross-device federated learning never sees a clean cohort: devices go
offline before a round starts, die mid-update after pulling the global, or
finish late. ``FailureModel`` injects all three into the round engine:

  * **dropout**: the client never starts the round. No download, no
    compute, no upload.
  * **crash (mid-update)**: the client downloads θ_global (charged), then
    dies. Its local progress is lost, its ``ClientState`` stays as it was
    (``rounds_participated`` does not advance), nothing is uploaded.
  * **straggler**: the client finishes, ``straggler_ticks`` late, so its
    upload lands staler. Only the buffered engine reads it; the
    synchronized engines ignore straggling, as in the JAX package.

Every draw is a pure function of ``(seed, round, cid, kind)`` with no
carried state, the kinds independent, so a schedule is independent
of training and replays exactly across a checkpoint and resume. The JAX
package draws ``jax.random.uniform`` over ``fold_in(fold_in(round_key(seed,
round), cid), kind)``, which the port cannot reproduce; it keeps the
contract, as its samplers do: a uniform from numpy's ``SeedSequence([seed,
round, cid, kind])``, drawn on the host, so a schedule is the same on the
CPU and the card.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

# the draw streams of a (round, cid)
_KIND_DROP = 0
_KIND_CRASH = 1
_KIND_STRAGGLE = 2


@dataclass(frozen=True)
class FailureModel:
    """Seeded, stateless client churn for the round engine; ``round_idx`` is
    the synchronized round, or the buffered engine's dispatch tick."""

    dropout_prob: float = 0.0     # P(client never starts the round)
    crash_prob: float = 0.0       # P(client dies mid-update after download)
    straggler_prob: float = 0.0   # P(completion delayed; buffered engine)
    straggler_ticks: int = 3      # delay added to a straggling completion
    seed: int = 0

    def __post_init__(self):
        for name in ("dropout_prob", "crash_prob", "straggler_prob"):
            p = getattr(self, name)
            if not 0.0 <= p < 1.0:
                raise ValueError(f"{name} must be in [0, 1), got {p}")
        if self.straggler_ticks < 1:
            raise ValueError("straggler_ticks must be >= 1")

    @property
    def active(self) -> bool:
        return self.dropout_prob > 0.0 or self.crash_prob > 0.0 or self.straggler_prob > 0.0

    def _draw(self, kind: int, cid: int, round_idx: int) -> float:
        seq = np.random.SeedSequence([self.seed, round_idx, cid, kind])
        return float(np.random.default_rng(seq).random())

    def drops(self, cid: int, round_idx: int) -> bool:
        return (self.dropout_prob > 0.0
                and self._draw(_KIND_DROP, cid, round_idx) < self.dropout_prob)

    def crashes(self, cid: int, round_idx: int) -> bool:
        return self.crash_prob > 0.0 and self._draw(_KIND_CRASH, cid, round_idx) < self.crash_prob

    def straggles(self, cid: int, round_idx: int) -> bool:
        return (self.straggler_prob > 0.0
                and self._draw(_KIND_STRAGGLE, cid, round_idx) < self.straggler_prob)

    def to_dict(self) -> dict:
        """JSON-safe form, recorded in RunState meta."""
        return dataclasses.asdict(self)
