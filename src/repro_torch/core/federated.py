"""Federated orchestration, Alg. 1 of the paper (``repro.core.federated``).

``run_federated`` is a loop over the strategy hooks of
``repro_torch.strategies``:

    sampler.select             -> which clients run this round
    client.local_update        -> T local steps through the strategy's loss and
                                  FIM hooks
    strategy.post_local_update -> what each client offers for upload
    transforms[*].apply        -> DP, quantization, sparsification on the wire
    strategy.aggregate         -> the merge (through server_aggregate, which
                                  logs the traffic), or with ``agg_chunk``
                                  the streaming merge, a chunk at a time
    server_opt.apply           -> an optional FedOpt step on the merged result
    strategy.eval_params       -> which params each client evaluates at the end

The port runs the ``sequential`` engine; the vmap, sharded and buffered
engines raise ``NotImplementedError`` naming ROADMAP queues 5c and 6.

Fault tolerance rides on the same loop: ``checkpoint_dir`` snapshots the
whole round state (``repro_torch.checkpoint.RunState``: θ_global, the
ServerOpt moments, every client's AdamW and warmup state, transform
residuals, the comm log, the seed) every ``checkpoint_every`` rounds and
at the end; ``resume=`` restores a snapshot and replays: a resumed run's
numbers equal the uninterrupted run's on the same device, since nothing
random is carried (client init draws from ``seed + 2``, DP noise from
(cid, round), samplers and failures from (seed, round)). ``failures=
FailureModel(...)`` injects seeded dropout and mid-update crashes.
``run_centralized`` is the upper bound: one client holding the union of
the data.
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint import (CheckpointError, RunState, load_run_state, read_run_meta,
                                    resolve_run_state_dir, save_run_state, seed_key)
from repro_torch.core import client as client_lib
from repro_torch.core import server as server_lib
from repro_torch.core.client import ClientState, HyperParams
from repro_torch.core.comm import CommLog, RoundTraffic
from repro_torch.core.failures import FailureModel
from repro_torch.core.types import Batch
from repro_torch.strategies.base import get_strategy
from repro_torch.strategies.sampling import ClientSampler
from repro_torch.strategies.transforms import TransformCtx, default_transforms
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
    server_opt_state: Optional[object] = None  # final ServerOpt moments


def _not_ported(what: str, queue: str):
    raise NotImplementedError(f"{what}: not in the port yet (ROADMAP queue {queue})")


class _Checkpointer:
    """Writes RunState snapshots to ``dirpath/round_<n:06d>/`` and then names
    the newest in ``LATEST``, so ``resume=dirpath`` takes the newest complete
    one even after a crash mid-write (JAX ``federated.py:144-204``)."""

    def __init__(self, dirpath: str, every: int, *, seed: int, engine: str, strat, hp, cfg,
                 cids, transforms, failures, start: int = 0):
        self.dirpath = dirpath
        self.every = every
        self.engine = engine
        self.strat = strat
        self.cids = list(cids)
        self._last = start
        self._key = seed_key(seed)
        self._meta_extra = {
            "cfg_name": cfg.name,
            "hp": dataclasses.asdict(hp),
            "strategy_meta": strat.checkpoint_meta(),
            "transforms": [type(t).__name__ for t in transforms],
            "failure_model": failures.to_dict() if failures is not None else None,
        }

    def maybe_save(self, n: int, **kw) -> None:
        if self.every > 0 and n > self._last and n % self.every == 0:
            self.save(n, **kw)

    def final_save(self, n: int, **kw) -> None:
        if n > self._last:
            self.save(n, **kw)

    def save(self, n: int, *, server, clients, tstates, opt_state, metrics) -> None:
        rs = RunState(engine=self.engine, strategy=self.strat.name, round_idx=n,
                      server_round_idx=server.round_idx, rng_key=self._key,
                      global_adapters=server.global_adapters, server_opt_state=opt_state,
                      clients=list(clients), tstates=[list(tstates[c]) for c in self.cids],
                      round_metrics=list(metrics), comm_rounds=server.comm.state_dict(),
                      meta_extra=self._meta_extra)
        sub = f"round_{n:06d}"
        save_run_state(os.path.join(self.dirpath, sub), rs)
        with open(os.path.join(self.dirpath, "LATEST"), "w") as f:
            f.write(sub)
        self._last = n


def _load_resume(resume: str, *, seed: int, engine, strat, hp, cfg, server, clients,
                 server_opt, transforms) -> RunState:
    """Restore a RunState and check it against this run (JAX
    ``federated.py:207-254``). Resume means replay: the snapshot must come
    from a run with the same engine, strategy, config, hyperparameters,
    transform chain and seed; anything else is a fork and raises. A snapshot
    the JAX package wrote loads, but its ``rng_key`` is a JAX key, never the
    port's ``seed_key``, so resuming it is refused."""
    dirpath = resolve_run_state_dir(resume)
    meta = read_run_meta(dirpath)

    def bail(what, saved, current):
        raise CheckpointError(
            f"cannot resume from {dirpath!r}: checkpoint {what} is {saved!r}, this run uses "
            f"{current!r} — resuming would not replay the original run (start a fresh run "
            "or convert the checkpoint explicitly)")

    if meta["engine"] != engine:
        bail("engine", meta["engine"], engine)
    if meta.get("strategy_meta") != strat.checkpoint_meta():
        bail("strategy", meta.get("strategy_meta"), strat.checkpoint_meta())
    if meta.get("cfg_name") != cfg.name:
        bail("config", meta.get("cfg_name"), cfg.name)
    if meta.get("hp") != dataclasses.asdict(hp):
        bail("hyperparameters", meta.get("hp"), dataclasses.asdict(hp))
    tnames = [type(t).__name__ for t in transforms]
    if meta.get("transforms") != tnames:
        bail("transform chain", meta.get("transforms"), tnames)
    rs = load_run_state(
        dirpath, clients_ref=clients, global_ref=server.global_adapters,
        server_opt_state_ref=(server_opt.init(server.global_adapters)
                              if server_opt is not None else None),
        transform_templates=[t.state_template(server.global_adapters) for t in transforms])
    if not np.array_equal(np.asarray(rs.rng_key), seed_key(seed)):
        raise CheckpointError(
            f"cannot resume from {dirpath!r}: the checkpoint was written under a different "
            f"seed (its rng_key {np.asarray(rs.rng_key).tolist()}, this run's "
            f"{seed_key(seed).tolist()}) — the backbone and the clients' init are drawn "
            "again from the seed at resume, so replay needs the same seed")
    return rs


def _default_device(server):
    return tree_leaves(server.global_adapters)[0].device if server is not None else "cuda"


def run_federated(seed: int, cfg, train_data: Dict[int, List[Batch]],
                  eval_data: Dict[int, List[Batch]], *, strategy="fednano", rounds: int = 10,
                  hp: HyperParams = HyperParams(), use_pallas: bool = False,
                  server: Optional[server_lib.ServerState] = None, verbose: bool = False,
                  transforms: Optional[Sequence] = None, server_opt=None,
                  sampler: Optional[ClientSampler] = None, engine: str = "sequential",
                  agg_chunk: Optional[int] = None, final_eval: bool = True,
                  failures: Optional[FailureModel] = None, checkpoint_dir: Optional[str] = None,
                  checkpoint_every: int = 0, resume: Optional[str] = None,
                  device=None) -> FederatedResult:
    """Run R rounds of federated NanoAdapter tuning.

    ``seed`` takes the place of the JAX package's PRNG key: it draws the server
    (unless ``server`` is given) on ``device``, and the clients' initial
    adapters on the CPU, moved to ``device`` (so a seed gives the same
    clients on the CPU and the card). Every strategy replaces those adapters
    by the global ones at the client's first round before any number is
    read; FedDPA-F's personal adapter is the one draw that stays. ``device``
    defaults to the given server's device, else ``cuda``. ``use_pallas``
    routes the server's Fisher merge through the fisher_merge / fisher_fold
    kernels; ``cfg.use_pallas`` routes the clients' adapters and attention
    through theirs. ``transforms`` defaults to the ``hp``-driven chain (DP, then
    int8 + EF), ``server_opt`` to the strategy's own, ``sampler`` to full
    participation. ``agg_chunk`` folds the uploads into a streaming merge
    every ``agg_chunk`` clients.

    Fault tolerance: ``failures`` injects seeded client churn
    (:class:`repro_torch.core.failures.FailureModel`); ``checkpoint_dir``
    with ``checkpoint_every=k`` snapshots the whole round state every k
    rounds and once at the end (``k=0``: only the end); ``resume=<dir>``
    restores a snapshot (the directory itself or its parent, whose
    ``LATEST`` is followed). Given the same seed, config, hp and strategy,
    the run replays where it left off: round metrics, comm totals and
    adapters equal the uninterrupted run's.
    """
    if engine not in ENGINES:
        _not_ported(f"engine={engine!r}", "6" if engine == "sharded" else "5c")
    strat = get_strategy(strategy)
    if transforms is None:
        transforms = default_transforms(hp)
    if server_opt is None:
        server_opt = strat.server_opt()
    if sampler is None:
        sampler = ClientSampler()

    if device is None:
        device = _default_device(server)
    if server is None:
        server = server_lib.init_server(cfg, seed=seed, device=device)
    cids = sorted(train_data)
    index_of = {cid: i for i, cid in enumerate(cids)}
    gen = torch.Generator().manual_seed(seed + 2)
    clients = [client_lib.to_device(strat.init_client(gen, cfg, cid, len(train_data[cid])),
                                    device) for cid in cids]
    tstates = {cid: [None] * len(transforms) for cid in cids}

    resume_state = None
    if resume is not None:
        resume_state = _load_resume(resume, seed=seed, engine=engine, strat=strat, hp=hp,
                                    cfg=cfg, server=server, clients=clients,
                                    server_opt=server_opt, transforms=transforms)
        server = dataclasses.replace(server, global_adapters=resume_state.global_adapters,
                                     comm=CommLog.from_state_dict(resume_state.comm_rounds),
                                     round_idx=resume_state.server_round_idx)
        clients[:] = resume_state.clients
        for i, cid in enumerate(cids):
            tstates[cid] = list(resume_state.tstates[i])
        if verbose:
            print(f"  [{strat.name}] resumed at round {resume_state.round_idx} from {resume}")

    ckpt = None
    if checkpoint_dir:
        ckpt = _Checkpointer(checkpoint_dir, checkpoint_every, seed=seed, engine=engine,
                             strat=strat, hp=hp, cfg=cfg, cids=cids, transforms=transforms,
                             failures=failures,
                             start=resume_state.round_idx if resume_state is not None else 0)

    result, server = _run_sync(cfg, server, strat, clients, cids, index_of, train_data, hp,
                               transforms, tstates, server_opt, sampler, rounds=rounds,
                               agg_chunk=agg_chunk, use_pallas=use_pallas, verbose=verbose,
                               failures=failures, ckpt=ckpt, resume_state=resume_state)
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


def _run_sync(cfg, server, strat, clients, cids, index_of, train_data, hp, transforms, tstates,
              server_opt, sampler, *, rounds, agg_chunk, use_pallas, verbose, failures=None,
              ckpt=None, resume_state=None):
    """Synchronized rounds, one client at a time (the JAX ``sequential`` engine)."""
    streaming = bool(agg_chunk) and strat.aggregates
    opt_state = server_opt.init(server.global_adapters) if server_opt is not None else None
    result = FederatedResult(strategy=strat.name)
    start_round = 0
    if resume_state is not None:
        start_round = resume_state.round_idx
        if resume_state.server_opt_state is not None:
            opt_state = resume_state.server_opt_state
        result.round_metrics = list(resume_state.round_metrics)
    for r in range(start_round, rounds):
        cohort = list(sampler.select(r, cids))
        gbytes = tree_bytes(server.global_adapters)
        down_bytes = wire_up = 0
        n_dropped = n_crashed = 0
        # dropped clients never start (no bytes, no compute); crashed clients
        # pull the global (charged), then die: progress lost, state as it was
        if failures is not None and failures.active:
            alive = [cid for cid in cohort if not failures.drops(cid, r)]
            n_dropped = len(cohort) - len(alive)
            cohort = []
            for cid in alive:
                if failures.crashes(cid, r):
                    if strat.downloads_global(clients[index_of[cid]].rounds_participated):
                        down_bytes += gbytes
                    n_crashed += 1
                else:
                    cohort.append(cid)
        losses: List[float] = []           # cohort order
        updates: List[tuple] = []          # (theta, fisher, size), cohort order
        stream_acc = strat.agg_stream_init() if streaming else None
        stream_buf: List[tuple] = []
        stream_bytes = {"param_up": 0, "fisher_up": 0}
        folded_any = False

        def apply_transforms(cid: int, theta):
            """-> (θ the server sees, wire bytes): the last size-changing
            transform of the chain sets the wire size, else the dense tree's."""
            ctx = TransformCtx(cid=cid, round_idx=r)
            theta_wire = None
            for j, t in enumerate(transforms):
                theta, tstates[cid][j], w = t.apply(ctx, theta, server.global_adapters,
                                                    tstates[cid][j])
                if w is not None:
                    theta_wire = w
            return theta, (theta_wire if theta_wire is not None else tree_bytes(theta))

        def fold_stream():
            nonlocal stream_acc, folded_any
            if not stream_buf:
                return
            ts, fs, ws = (list(col) for col in zip(*stream_buf))
            stream_bytes["param_up"] += sum(tree_bytes(t) for t in ts)
            stream_bytes["fisher_up"] += sum(tree_bytes(f) for f in fs if f is not None)
            stream_acc = strat.agg_stream_fold(stream_acc, ts, fs, ws, use_pallas=use_pallas)
            folded_any = True
            stream_buf.clear()

        for cid in cohort:
            i = index_of[cid]
            if strat.downloads_global(clients[i].rounds_participated):
                down_bytes += gbytes
            clients[i], metrics = client_lib.local_update(
                cfg, server.backbone, clients[i], train_data[cid], hp, strat,
                server.global_adapters, round_idx=r)
            theta, wbytes = apply_transforms(
                cid, strat.post_local_update(clients[i], server.global_adapters, r))
            wire_up += wbytes
            losses.append(metrics["loss_mean"])
            upload = (theta, clients[i].fisher, clients[i].n_examples)
            if streaming:
                stream_buf.append(upload)
                if len(stream_buf) >= agg_chunk:
                    fold_stream()
            else:
                updates.append(upload)

        if strat.aggregates and (updates or stream_buf or folded_any):
            prev_global = server.global_adapters
            if streaming:
                fold_stream()
                merged = strat.agg_stream_finalize(stream_acc, use_pallas=use_pallas)
                server = server_lib.server_commit(
                    server, merged, param_up=stream_bytes["param_up"],
                    fisher_up=stream_bytes["fisher_up"], param_down=down_bytes,
                    wire_up=wire_up)
            else:
                thetas, fishers, sizes = (list(col) for col in zip(*updates))
                server = server_lib.server_aggregate(
                    server, strat, thetas, fishers, sizes, down_bytes=down_bytes,
                    use_pallas=use_pallas, wire_up=wire_up)
            if server_opt is not None:
                new_global, opt_state = server_opt.apply(opt_state, prev_global,
                                                         server.global_adapters)
                server = dataclasses.replace(server, global_adapters=new_global)
        elif down_bytes:
            # no merge this round (LocFT, or every starter crashed), but the
            # global still crossed the wire
            server_lib.log_downloads(server, r, down_bytes)

        n = len(losses)
        # an empty cohort is not a perfect round: mean_loss None, never 0.0
        rm = {"round": r, "mean_loss": sum(losses) / n if n else None, "participants": n}
        if failures is not None:
            rm["dropped"] = n_dropped
            rm["crashed"] = n_crashed
        result.round_metrics.append(rm)
        if verbose:
            shown = ("skipped (no participants)" if n == 0
                     else f"mean local loss {rm['mean_loss']:.4f}")
            print(f"  [{strat.name}] round {r}: {shown}")
        if ckpt is not None:
            ckpt.maybe_save(r + 1, server=server, clients=clients, tstates=tstates,
                            opt_state=opt_state, metrics=result.round_metrics)
    if ckpt is not None:
        ckpt.final_save(rounds, server=server, clients=clients, tstates=tstates,
                        opt_state=opt_state, metrics=result.round_metrics)
    result.server_opt_state = opt_state
    return result, server


def run_centralized(seed: int, cfg, train_data: Dict[int, List[Batch]],
                    eval_data: Dict[int, List[Batch]], *, steps: int = 100,
                    hp: HyperParams = HyperParams(), verbose: bool = False,
                    server: Optional[server_lib.ServerState] = None,
                    device=None) -> FederatedResult:
    """Upper bound: one 'client' holding the union of all data, ``steps``
    local FedAvg steps from the global adapters. ``seed``, ``server`` and
    ``device`` as in :func:`run_federated`."""
    all_train: List[Batch] = []
    for cid in sorted(train_data):
        all_train.extend(train_data[cid])
    if device is None:
        device = _default_device(server)
    if server is None:
        server = server_lib.init_server(cfg, seed=seed, device=device)
    strat = get_strategy("fedavg")
    state = client_lib.to_device(strat.init_client(torch.Generator().manual_seed(seed + 2),
                                                   cfg, 0, len(all_train)), device)
    hp_c = HyperParams(lr=hp.lr, weight_decay=hp.weight_decay, grad_clip=hp.grad_clip,
                       local_steps=steps, prox_mu=hp.prox_mu, fisher_batches=hp.fisher_batches)
    state, metrics = client_lib.local_update(cfg, server.backbone, state, all_train, hp_c,
                                             strat, server.global_adapters, round_idx=0)
    result = FederatedResult(strategy="centralized")
    result.round_metrics.append({"round": 0, "mean_loss": metrics["loss_mean"],
                                 "participants": 1})
    # the bound still moves bytes: one broadcast down, one upload back
    server.comm.log_round(RoundTraffic(round_idx=0, param_up=tree_bytes(state.adapters),
                                       param_down=tree_bytes(server.global_adapters),
                                       param_up_wire=tree_bytes(state.adapters)))
    for cid in sorted(eval_data):
        result.client_accuracy[cid] = client_lib.eval_client(cfg, server.backbone,
                                                             state.adapters, None,
                                                             eval_data[cid])
    result.avg_accuracy = sum(result.client_accuracy.values()) / len(result.client_accuracy)
    result.comm_totals = server.comm.totals()
    result.server = server
    result.clients = [state]
    if verbose:
        print(f"  [centralized] acc {result.avg_accuracy:.4f}")
    return result
