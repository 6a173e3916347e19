"""Bytes-on-the-wire accounting (``repro.core.comm``, paper Tab. 1): what each
round ships on the parameter plane, summed over clients.

FedNano ships NanoAdapters up (plus the diagonal FIM) and the merged
adapters down; ``param_up_wire`` is what the upload transforms put on the
wire. The activation-plane fields (split execution's embeddings up and
their gradients down) are kept for the JAX package's schema; the engine
logs none, as the JAX engine does not either.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class RoundTraffic:
    round_idx: int
    param_up: int = 0        # bytes: adapters uploaded, summed over clients
    param_down: int = 0      # bytes: merged adapters broadcast
    fisher_up: int = 0       # bytes: diagonal FIM uploads (FedNano only)
    act_up: int = 0          # bytes: split activations client -> server
    act_down: int = 0        # bytes: gradient activations server -> client
    param_up_wire: int = 0   # bytes on the wire after upload transforms

    def to_dict(self) -> Dict[str, int]:
        """JSON-safe form (checkpoints keep the whole per-round log, so a
        resumed run's totals equal the uninterrupted run's byte for byte)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, int]) -> "RoundTraffic":
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"RoundTraffic checkpoint entry carries unknown fields "
                             f"{sorted(unknown)}; the comm-log format has diverged")
        return cls(**d)


@dataclass
class CommLog:
    rounds: List[RoundTraffic] = field(default_factory=list)

    def log_round(self, r: RoundTraffic):
        self.rounds.append(r)

    def totals(self) -> Dict[str, int]:
        out = {"param_up": 0, "param_down": 0, "fisher_up": 0, "act_up": 0,
               "act_down": 0, "param_up_wire": 0}
        for r in self.rounds:
            for k in out:
                out[k] += getattr(r, k)
        return out

    def state_dict(self) -> List[Dict[str, int]]:
        return [r.to_dict() for r in self.rounds]

    @classmethod
    def from_state_dict(cls, rounds: List[Dict[str, int]]) -> "CommLog":
        return cls(rounds=[RoundTraffic.from_dict(d) for d in rounds])
