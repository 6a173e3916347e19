"""Server state: the frozen LLM + global NanoAdapters (Alg. 1, ServerUpdate;
``repro.core.server``). The server also runs the Fisher-guided merge and
keeps the communication log."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from repro_torch.core import adapters as adapters_lib
from repro_torch.core.comm import CommLog, RoundTraffic
from repro_torch.models import model as model_lib
from repro_torch.utils import tree_bytes


@dataclass
class ServerState:
    cfg: object
    backbone: Dict                  # frozen: never updated after init
    global_adapters: Dict           # current θ_global
    comm: CommLog = field(default_factory=CommLog)
    round_idx: int = 0


def init_server(cfg, *, seed: int = 0, device="cuda") -> ServerState:
    """Backbone and global adapters drawn from seeded generators on ``device``."""
    backbone = model_lib.init_backbone(cfg, seed=seed, device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    return ServerState(cfg=cfg, backbone=backbone,
                       global_adapters=adapters_lib.init_nanoedge(gen, cfg))


def server_commit(server: ServerState, merged: Optional[Dict], *, param_up: int,
                  fisher_up: int, param_down: int, wire_up: int) -> ServerState:
    """Install a merged result (``None`` keeps the global adapters) and log
    the round's traffic (the low-level half of :func:`server_aggregate`, used
    by the streaming merge)."""
    server.comm.log_round(RoundTraffic(
        round_idx=server.round_idx, param_up=param_up, fisher_up=fisher_up,
        param_down=param_down, param_up_wire=wire_up))
    return dataclasses.replace(
        server,
        global_adapters=merged if merged is not None else server.global_adapters,
        round_idx=server.round_idx + 1,
    )


def log_downloads(server: ServerState, round_idx: int, down_bytes: int) -> None:
    """Log the broadcast of a round with no merge (LocFT's round 0): the
    bytes still crossed the wire."""
    if down_bytes:
        server.comm.log_round(RoundTraffic(round_idx=round_idx, param_down=down_bytes))


def server_aggregate(server: ServerState, strategy, thetas: List[Dict],
                     fishers: List[Optional[Dict]], data_sizes: List[int], *,
                     down_bytes: int, wire_up: int,
                     use_pallas: bool = False) -> ServerState:
    """Alg. 1 line 7: θ_global <- ServerAgg({θ_k, F_k}).

    ``down_bytes`` is what the round's cohort pulled at round start, ``wire_up``
    what it sent. Uploads without a FIM count no Fisher bytes.
    """
    from repro_torch.strategies.base import get_strategy

    merged = get_strategy(strategy).aggregate(thetas, fishers, data_sizes,
                                              use_pallas=use_pallas)
    param_up = sum(tree_bytes(t) for t in thetas)
    fisher_up = sum(tree_bytes(f) for f in fishers if f is not None)
    return server_commit(server, merged, param_up=param_up, fisher_up=fisher_up,
                         param_down=down_bytes, wire_up=wire_up)
