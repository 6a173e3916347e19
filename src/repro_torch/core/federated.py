"""Federated orchestration, Alg. 1 of the paper (``repro.core.federated``).

``run_federated`` is a loop over the strategy hooks of
``repro_torch.strategies``:

    client.local_update        -> T local AdamW steps + the dedicated FIM pass
    strategy.post_local_update -> what each client uploads
    strategy.aggregate         -> the Fisher merge (through server_aggregate,
                                  which logs the traffic), or with ``agg_chunk``
                                  the streaming merge, one upload at a time
    strategy.eval_params       -> which params each client evaluates at the end

The port runs the ``sequential`` engine with full participation. What the
JAX engine has beyond that raises ``NotImplementedError`` naming its ROADMAP
queue: the vmap, sharded and buffered engines, checkpoints and resume, and
failure injection (queue 5), upload transforms, server optimizers and client
samplers (queue 2).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from repro_torch.core import client as client_lib
from repro_torch.core import server as server_lib
from repro_torch.core.client import ClientState, HyperParams
from repro_torch.core.types import Batch
from repro_torch.strategies.base import get_strategy
from repro_torch.utils import tree_bytes, tree_leaves

ENGINES = ("sequential",)


@dataclass
class FederatedResult:
    strategy: str
    round_metrics: List[Dict] = field(default_factory=list)
    client_accuracy: Dict[int, float] = field(default_factory=dict)
    avg_accuracy: float = 0.0
    comm_totals: Dict[str, int] = field(default_factory=dict)
    server: Optional[object] = None
    clients: Optional[List[ClientState]] = None
    engine: str = "sequential"


def _not_ported(what: str, queue: int):
    raise NotImplementedError(f"{what}: not in the port yet (ROADMAP queue {queue})")


def run_federated(seed: int, cfg, train_data: Dict[int, List[Batch]],
                  eval_data: Dict[int, List[Batch]], *, strategy="fednano", rounds: int = 10,
                  hp: HyperParams = HyperParams(), use_pallas: bool = False,
                  server: Optional[server_lib.ServerState] = None, verbose: bool = False,
                  transforms=None, server_opt=None, sampler=None, engine: str = "sequential",
                  agg_chunk: Optional[int] = None, final_eval: bool = True, failures=None,
                  checkpoint_dir: Optional[str] = None, resume: Optional[str] = None,
                  device=None) -> FederatedResult:
    """Run R rounds of federated NanoAdapter tuning.

    ``seed`` takes the place of the JAX package's PRNG key: it draws the server
    (unless ``server`` is given) and the clients' initial adapters, which
    FedNano replaces by the global adapters at round 0 before any number
    is read. ``device`` is where those are drawn: by default the given
    server's device, else ``cuda``. ``use_pallas`` routes the server's merge
    through the fisher_merge / fisher_fold kernels; ``cfg.use_pallas`` routes
    the clients' adapters and attention through theirs. ``agg_chunk`` folds
    the uploads into a streaming merge every ``agg_chunk`` clients.
    """
    if engine not in ENGINES:
        _not_ported(f"engine={engine!r}", 5)
    if transforms or hp.dp_clip > 0.0 or hp.compress_uploads:
        _not_ported("upload transforms (dp_clip, compress_uploads)", 2)
    if server_opt is not None:
        _not_ported("server_opt", 2)
    if sampler is not None:
        _not_ported("client samplers", 2)
    if failures is not None:
        _not_ported("failure injection", 5)
    if checkpoint_dir is not None or resume is not None:
        _not_ported("checkpoints and resume", 5)
    strat = get_strategy(strategy)

    if device is None:
        device = (tree_leaves(server.global_adapters)[0].device if server is not None
                  else "cuda")
    if server is None:
        server = server_lib.init_server(cfg, seed=seed, device=device)
    cids = sorted(train_data)
    index_of = {cid: i for i, cid in enumerate(cids)}
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    clients = [strat.init_client(gen, cfg, cid, len(train_data[cid])) for cid in cids]

    result, server = _run_sync(cfg, server, strat, clients, cids, index_of, train_data, hp,
                               rounds=rounds, agg_chunk=agg_chunk, use_pallas=use_pallas,
                               verbose=verbose)
    if final_eval:
        for cid in cids:
            adp, ladp = strat.eval_params(server.global_adapters, clients[index_of[cid]])
            result.client_accuracy[cid] = client_lib.eval_client(cfg, server.backbone, adp,
                                                                 ladp, eval_data[cid])
        result.avg_accuracy = sum(result.client_accuracy.values()) / max(len(cids), 1)
    result.comm_totals = server.comm.totals()
    result.server = server
    result.clients = clients
    return result


def _run_sync(cfg, server, strat, clients, cids, index_of, train_data, hp, *, rounds,
              agg_chunk, use_pallas, verbose):
    """Synchronized rounds, one client at a time (the JAX ``sequential`` engine)."""
    streaming = bool(agg_chunk)
    result = FederatedResult(strategy=strat.name)
    for r in range(rounds):
        gbytes = tree_bytes(server.global_adapters)
        down_bytes = wire_up = 0
        losses: List[float] = []
        updates: List[tuple] = []          # (theta, fisher, size), cohort order
        stream_acc = strat.agg_stream_init() if streaming else None
        stream_buf: List[tuple] = []
        stream_bytes = {"param_up": 0, "fisher_up": 0}

        def fold_stream():
            nonlocal stream_acc
            if not stream_buf:
                return
            ts, fs, ws = (list(col) for col in zip(*stream_buf))
            stream_bytes["param_up"] += sum(tree_bytes(t) for t in ts)
            stream_bytes["fisher_up"] += sum(tree_bytes(f) for f in fs)
            stream_acc = strat.agg_stream_fold(stream_acc, ts, fs, ws, use_pallas=use_pallas)
            stream_buf.clear()

        for cid in cids:
            i = index_of[cid]
            if strat.downloads_global(clients[i].rounds_participated):
                down_bytes += gbytes
            clients[i], metrics = client_lib.local_update(
                cfg, server.backbone, clients[i], train_data[cid], hp, strat,
                server.global_adapters, round_idx=r)
            theta = strat.post_local_update(clients[i], server.global_adapters, r)
            wire_up += tree_bytes(theta)
            losses.append(metrics["loss_mean"])
            upload = (theta, clients[i].fisher, clients[i].n_examples)
            if streaming:
                stream_buf.append(upload)
                if len(stream_buf) >= agg_chunk:
                    fold_stream()
            else:
                updates.append(upload)

        if streaming:
            fold_stream()
            merged = strat.agg_stream_finalize(stream_acc, use_pallas=use_pallas)
            server = server_lib.server_commit(
                server, merged, param_up=stream_bytes["param_up"],
                fisher_up=stream_bytes["fisher_up"], param_down=down_bytes, wire_up=wire_up)
        else:
            thetas, fishers, sizes = (list(col) for col in zip(*updates))
            server = server_lib.server_aggregate(
                server, strat, thetas, fishers, sizes, down_bytes=down_bytes,
                use_pallas=use_pallas, wire_up=wire_up)

        rm = {"round": r, "mean_loss": sum(losses) / len(losses), "participants": len(losses)}
        result.round_metrics.append(rm)
        if verbose:
            print(f"  [{strat.name}] round {r}: mean local loss {rm['mean_loss']:.4f}")
    return result, server
