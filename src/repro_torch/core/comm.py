"""Bytes-on-the-wire accounting (``repro.core.comm``, paper Tab. 1): what each
round ships on the parameter plane, summed over clients.

FedNano ships NanoAdapters up (plus the diagonal FIM) and the merged
adapters down. The activation-plane fields (split execution's embeddings
up and their gradients down) are kept for the JAX package's schema; the
training slice logs none, as the JAX engine does not either.
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
                             # (== param_up: the port has no transforms yet)

    def to_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


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
