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

Four engines share those hooks:

  * ``sequential``: one client at a time.
  * ``vmap``: each round's cohort grouped by its schedule flags (download,
    warmup), each group cut into chunks of ``agg_chunk`` clients (else
    whole) and run by ``client.local_update_many``: the chunk's clients
    folded into one batch through the frozen backbone, a step for all of
    them at once. Uploads are offered client by client in plan order, so
    the merge and the streaming folds see what the sequential engine's
    would; round metrics keep cohort order.
  * ``sharded``: the vmap layout over a ``("clients",)`` mesh
    (``repro_torch.sharding.client_mesh``, or a ``ClientMesh`` that may
    name one card more than once): each chunk of a multiple of D clients
    is cut into D row blocks, block d through the same cohort update on
    ``devices[d]``; a chunk that does not fill the width repeats its last
    client, and those rows reach no merge, metric or byte count. Each flag
    group runs in ``_PIPELINE_CHUNKS`` chunks at least, at most
    ``_CHUNK_WIDTH_CAP`` wide. With ``overlap`` the engine keeps two
    chunks in flight: the host stacks and queues chunk k+1 before it
    collects chunk k. A chunk's stacked AdamW state stays on the devices
    across rounds (``resident``; the ``ClientState`` fields go stale while
    ``home`` names the chunk, and ``materialize`` writes the rows back
    before a snapshot, a reshuffled cohort and the end of the run), as do
    its stacked batches (``batch_cache``). When every upload is the raw
    adapter tree (``fast_agg``) the round's outputs stay where they are and
    fold into the merge by ``agg_stream_fold_stacked`` at the round's end,
    padding rows at weight 0, their losses brought to the host in one copy.
  * ``buffered``: FedBuff-style asynchronous merging. Clients train against
    the global version they last downloaded; a completion-ordered event
    loop over integer ticks fills a server buffer, and every
    ``buffer_size`` completions merge with weights n/(1+τ)^p, τ the merges
    since the client started. ``latency_fn(cid, version)`` gives a run's
    ticks; a straggler (``FailureModel.straggles``) adds
    ``straggler_ticks``; ``rounds`` counts merges.

Fault tolerance rides on the same loop: ``checkpoint_dir`` snapshots the
whole round state (``repro_torch.checkpoint.RunState``: θ_global, the
ServerOpt moments, every client's AdamW and warmup state, transform
residuals, the comm log, the seed, and the buffered engine's event heap,
version snapshots and merge buffer) every ``checkpoint_every`` rounds
(merges) and at the end; ``resume=`` restores a snapshot and replays: a resumed run's
numbers equal the uninterrupted run's on the same device, since nothing
random is carried (client init draws from ``seed + 2``, DP noise from
(cid, round), samplers and failures from (seed, round)). ``failures=
FailureModel(...)`` injects seeded dropout, mid-update crashes and (in the
buffered engine) stragglers.
``run_centralized`` is the upper bound: one client holding the union of
the data.
"""
from __future__ import annotations

import dataclasses
import heapq
import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint import (BufferedState, CheckpointError, RunState, load_run_state,
                                    read_run_meta, resolve_run_state_dir, save_run_state,
                                    seed_key)
from repro_torch.core import client as client_lib
from repro_torch.core import server as server_lib
from repro_torch.core.client import ClientState, HyperParams
from repro_torch.core.comm import CommLog, RoundTraffic
from repro_torch.core.failures import FailureModel
from repro_torch.core.types import Batch
from repro_torch.sharding import ClientMesh, client_mesh, pad_to_multiple, replicate
from repro_torch.strategies.base import Strategy, get_strategy
from repro_torch.strategies.sampling import ClientSampler
from repro_torch.strategies.transforms import TransformCtx, default_transforms
from repro_torch.utils import tree_bytes, tree_leaves
from repro_torch.utils.trace import span

ENGINES = ("sequential", "vmap", "sharded", "buffered")

# Without agg_chunk the sharded engine cuts each flag group into at least this
# many chunks (each a multiple of the mesh size wide), so that the two-deep
# pipeline has launches to overlap, and caps a chunk at _CHUNK_WIDTH_CAP
# clients (the JAX package's values; a chunk's width changes no number:
# uploads are offered client by client in plan order and the streaming folds
# trigger at agg_chunk boundaries only).
_PIPELINE_CHUNKS = 16
_CHUNK_WIDTH_CAP = 128

# buffered-engine event kinds: RUN completes a local update; RETRY is a
# failed attempt (dropout or crash) coming back to be dispatched again
_EV_RUN = 0
_EV_RETRY = 1


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
    setup_s: float = 0.0          # wall seconds spent initializing the clients


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

    def would_save(self, n: int) -> bool:
        return self.every > 0 and n > self._last and n % self.every == 0

    def maybe_save(self, n: int, **kw) -> None:
        if self.would_save(n):
            self.save(n, **kw)

    def final_save(self, n: int, **kw) -> None:
        if n > self._last:
            self.save(n, **kw)

    def save(self, n: int, *, server, clients, tstates, opt_state, metrics,
             buffered: Optional[BufferedState] = None) -> None:
        rs = RunState(engine=self.engine, strategy=self.strat.name, round_idx=n,
                      server_round_idx=server.round_idx, rng_key=self._key,
                      global_adapters=server.global_adapters, server_opt_state=opt_state,
                      clients=list(clients), tstates=[list(tstates[c]) for c in self.cids],
                      round_metrics=list(metrics), comm_rounds=server.comm.state_dict(),
                      buffered=buffered, meta_extra=self._meta_extra)
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
                  buffer_size: Optional[int] = None, staleness_power: float = 0.5,
                  latency_fn: Optional[Callable[[int, int], int]] = None,
                  devices=None, overlap: bool = True, device=None) -> FederatedResult:
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
    every ``agg_chunk`` clients (and, under ``engine="vmap"``, runs the
    cohort in chunks of that many). ``engine`` picks the execution path
    (module docstring); ``buffer_size`` (default half the clients),
    ``staleness_power`` and ``latency_fn(cid, version) -> ticks`` (default
    1) set up the buffered engine, whose ``rounds`` are merges. ``devices``
    (sharded engine only) is the mesh: a count of ``device``'s kind
    (default all visible cards; on the CPU logical shards, default 1) or a
    :class:`~repro_torch.sharding.ClientMesh`; ``overlap=False`` turns the
    sharded engine's two-deep pipeline off.

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
        raise ValueError(f"unknown engine {engine!r}; choose from {ENGINES}")
    if devices is not None and engine != "sharded":
        raise ValueError("devices= only applies to engine='sharded'")
    strat = get_strategy(strategy)
    if transforms is None:
        transforms = default_transforms(hp)
    if server_opt is None:
        server_opt = strat.server_opt()
    if sampler is None:
        sampler = ClientSampler()

    if device is None:
        device = _default_device(server)
    mesh = None
    if engine == "sharded":
        mesh = devices if isinstance(devices, ClientMesh) else client_mesh(devices, device)
    if server is None:
        server = server_lib.init_server(cfg, seed=seed, device=device)
    cids = sorted(train_data)
    index_of = {cid: i for i, cid in enumerate(cids)}
    gen = torch.Generator().manual_seed(seed + 2)
    t0 = time.perf_counter()
    clients = [client_lib.to_device(c, device) for c in strat.init_clients(
        gen, cfg, cids, [len(train_data[cid]) for cid in cids])]
    setup_s = time.perf_counter() - t0
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
            print(f"  [{strat.name}] resumed at "
                  f"{'merge' if engine == 'buffered' else 'round'} "
                  f"{resume_state.round_idx} from {resume}")

    ckpt = None
    if checkpoint_dir:
        ckpt = _Checkpointer(checkpoint_dir, checkpoint_every, seed=seed, engine=engine,
                             strat=strat, hp=hp, cfg=cfg, cids=cids, transforms=transforms,
                             failures=failures,
                             start=resume_state.round_idx if resume_state is not None else 0)

    if engine == "buffered":
        result, server = _run_buffered(
            cfg, server, strat, clients, cids, index_of, train_data, hp, transforms, tstates,
            server_opt, rounds=rounds, buffer_size=buffer_size,
            staleness_power=staleness_power, latency_fn=latency_fn, use_pallas=use_pallas,
            verbose=verbose, failures=failures, ckpt=ckpt, resume_state=resume_state)
    else:
        result, server = _run_sync(cfg, server, strat, clients, cids, index_of, train_data, hp,
                                   transforms, tstates, server_opt, sampler, rounds=rounds,
                                   engine=engine, agg_chunk=agg_chunk, use_pallas=use_pallas,
                                   verbose=verbose, failures=failures, ckpt=ckpt,
                                   resume_state=resume_state, mesh=mesh, overlap=overlap)
    result.setup_s = setup_s
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


def _chunks(seq: List, width: int):
    for i in range(0, len(seq), width):
        yield seq[i: i + width]


def _run_sync(cfg, server, strat, clients, cids, index_of, train_data, hp, transforms, tstates,
              server_opt, sampler, *, rounds, engine, agg_chunk, use_pallas, verbose,
              failures=None, ckpt=None, resume_state=None, mesh: Optional[ClientMesh] = None,
              overlap: bool = True):
    """Synchronized rounds: ``engine`` is "sequential", "vmap" or "sharded"
    (``mesh`` given)."""
    streaming = bool(agg_chunk) and strat.aggregates
    opt_state = server_opt.init(server.global_adapters) if server_opt is not None else None
    result = FederatedResult(strategy=strat.name, engine=engine)
    start_round = 0
    if resume_state is not None:
        start_round = resume_state.round_idx
        if resume_state.server_opt_state is not None:
            opt_state = resume_state.server_opt_state
        result.round_metrics = list(resume_state.round_metrics)

    # the frozen backbone on each distinct mesh device once for the run; the
    # global adapters again at each round's start
    backbone_dev = replicate(server.backbone, mesh) if mesh is not None else server.backbone
    # chunk-resident client state (sharded engine): a chunk's stacked AdamW
    # state, and in fast_agg rounds its adapters and Fisher too, stays on the
    # devices between rounds and feeds the next round's launch of the same
    # chunk. A client's ClientState fields go stale while ``home`` names its
    # chunk; ``materialize`` writes the true rows back before anything reads
    # them (a snapshot, a reshuffled cohort, the end of the run).
    resident: Dict[tuple, dict] = {}   # chunk key -> {k, opt, adp, fish}
    home: Dict[int, tuple] = {}        # cid -> chunk key holding its rows
    # a client's batches never change within a run, so a chunk's stacked and
    # placed (train, warm, Fisher) batches are the same every round it recurs
    batch_cache: Dict[tuple, tuple] = {}

    def materialize(cids_needed=None):
        keys = ({home[c] for c in cids_needed if c in home} if cids_needed is not None
                else set(home.values()))
        for ck in keys:
            ent = resident[ck]
            kk = ent["k"]
            rows = {field: ent[key].rows(kk) for field, key in
                    (("opt_state", "opt"), ("adapters", "adp"), ("fisher", "fish"))
                    if ent[key] is not None}
            for j, c in enumerate(ck):
                if home.get(c) != ck:
                    continue
                clients[index_of[c]] = dataclasses.replace(
                    clients[index_of[c]], **{f: r[j] for f, r in rows.items()})
                del home[c]

    for r in range(start_round, rounds):
        cohort = list(sampler.select(r, cids))
        with span("nano.round", {"round": r, "cohort": len(cohort)}, device=True):
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
            losses: Dict[int, float] = {}      # cid -> loss_mean
            updates: List[tuple] = []          # (theta, fisher, size), offer order
            stream_acc = strat.agg_stream_init() if streaming else None
            stream_buf: List[tuple] = []
            stream_bytes = {"param_up": 0, "fisher_up": 0}
            folded_any = False
            # the sharded engine's stacked merge: the round's outputs fold where
            # they lie at its end, padding rows at weight 0
            fast_pend: List[tuple] = []        # (theta stack, fisher stack, weights)
            fast_losses: List[tuple] = []      # (chunk, device losses, real k)
            fast_bytes = {"param_up": 0, "fisher_up": 0}

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

            def offer(cid: int, state: ClientState, loss_mean: float):
                nonlocal wire_up
                with span("nano.round.upload", {"cid": cid}):
                    theta, wbytes = apply_transforms(
                        cid, strat.post_local_update(state, server.global_adapters, r))
                wire_up += wbytes
                losses[cid] = loss_mean
                upload = (theta, state.fisher, state.n_examples)
                if streaming:
                    stream_buf.append(upload)
                    if len(stream_buf) >= agg_chunk:
                        fold_stream()
                else:
                    updates.append(upload)

            if engine == "sequential":
                for cid in cohort:
                    i = index_of[cid]
                    if strat.downloads_global(clients[i].rounds_participated):
                        down_bytes += gbytes
                    with span("nano.round.update", {"cid": cid}, device=True):
                        clients[i], metrics = client_lib.local_update(
                            cfg, server.backbone, clients[i], train_data[cid], hp, strat,
                            server.global_adapters, round_idx=r)
                    offer(cid, clients[i], metrics["loss_mean"])
            else:  # vmap, sharded: group the cohort by its schedule flags, then run chunks
                groups: Dict[tuple, List[int]] = {}
                for cid in cohort:
                    st = clients[index_of[cid]]
                    p = st.rounds_participated
                    flags = (strat.downloads_global(p),
                             st.local_adapters is not None and strat.local_warmup(p, hp))
                    groups.setdefault(flags, []).append(cid)
                global_dev = server.global_adapters
                if mesh is not None:
                    global_dev = replicate(server.global_adapters, mesh)

                # the plan: (downloads, chunk) over every flag group
                plan: List[tuple] = []
                for (downloads, _), gcids in groups.items():
                    width = agg_chunk or len(gcids)
                    if mesh is not None:
                        width = pad_to_multiple(agg_chunk or min(
                            _CHUNK_WIDTH_CAP, max(1, -(-len(gcids) // _PIPELINE_CHUNKS))),
                            mesh.size)
                    plan.extend((downloads, chunk) for chunk in _chunks(gcids, width))

                # the stacked outputs are the uploads when every upload is the raw
                # adapter tree (stock post_local_update, no wire transforms, no
                # personal adapters) and every chunk downloads the global: then
                # they fold into the merge where they lie
                fast_agg = (
                    mesh is not None and strat.aggregates and not use_pallas and not transforms
                    and type(strat).post_local_update is Strategy.post_local_update
                    and all(flags[0] for flags in groups)
                    and not any(clients[index_of[g[0]]].local_adapters is not None
                                for g in groups.values()))

                # two chunks in flight (sharded + overlap): the host stacks and
                # queues chunk k+1 before it collects chunk k
                depth = 2 if (mesh is not None and overlap) else 1
                inflight: deque = deque()

                def collect_one():
                    nonlocal down_bytes, wire_up
                    downloads, chunk, launched = inflight.popleft()
                    kc = len(chunk)
                    if downloads:
                        down_bytes += gbytes * kc
                    ck = tuple(chunk)
                    if fast_agg:
                        # nothing leaves the devices: adapters, AdamW state and
                        # Fisher wait for the round's stacked merge, the losses
                        # for one copy at the round's end
                        with span("nano.round.collect"):
                            new_states, loss_dev = client_lib.collect_cohort_deferred(launched)
                        outs = launched.outs
                        wants_f = launched.prepared.wants_fisher is not None
                        resident[ck] = {"k": kc, "opt": outs[1], "adp": outs[0],
                                        "fish": outs[4] if wants_f else None}
                        for c, ns in zip(chunk, new_states):
                            home[c] = ck
                            clients[index_of[c]] = ns
                        width = outs[0].width
                        fast_pend.append((outs[0], outs[4] if wants_f else None,
                                          [float(clients[index_of[c]].n_examples) for c in chunk]
                                          + [0.0] * (width - kc)))
                        fast_bytes["param_up"] += outs[0].row_bytes() * kc
                        wire_up += outs[0].row_bytes() * kc
                        if wants_f:
                            fast_bytes["fisher_up"] += outs[4].row_bytes() * kc
                        fast_losses.append((chunk, loss_dev, kc))
                        return
                    if mesh is not None:
                        # the new AdamW state stays on the devices; the clients'
                        # own opt_state goes stale until materialize
                        with span("nano.round.collect"):
                            new_states, mets = client_lib.collect_cohort(launched,
                                                                         with_opt=False)
                        resident[ck] = {"k": kc, "opt": launched.outs[1], "adp": None,
                                        "fish": None}
                        for c in chunk:
                            home[c] = ck
                    else:
                        with span("nano.round.collect"):
                            new_states, mets = client_lib.collect_cohort(launched)
                    for c, ns, m in zip(chunk, new_states, mets):
                        clients[index_of[c]] = ns
                        offer(c, ns, m["loss_mean"])

                for downloads, chunk in plan:
                    opt0 = bx = None
                    if mesh is not None:
                        ck = tuple(chunk)
                        bx = batch_cache.get(ck)
                        if (all(home.get(c) == ck for c in chunk)
                                and (downloads or resident[ck]["adp"] is None)):
                            opt0 = resident[ck]["opt"]
                        else:
                            # a reshuffled cohort (or stale adapters would be
                            # stacked): the resident rows back to their
                            # ClientStates before stacking
                            materialize([c for c in chunk if c in home])
                    with span("nano.round.prepare", {"clients": len(chunk)}):
                        prepared = client_lib.prepare_cohort(
                            cfg, [clients[index_of[c]] for c in chunk],
                            [train_data[c] for c in chunk], hp, strat, mesh=mesh,
                            opt0_override=opt0, batches_override=bx)
                    if mesh is not None and bx is None:
                        batch_cache[ck] = prepared.args[4:7]
                    with span("nano.round.update", {"clients": len(chunk)}, device=True):
                        launched = client_lib.launch_cohort(prepared, backbone_dev, global_dev)
                    inflight.append((downloads, chunk, launched))
                    if len(inflight) >= depth:
                        collect_one()
                while inflight:
                    collect_one()
                # drop resident chunks no client points at any more (reshuffles)
                # and the batch stacks of chunks this round did not run
                live = set(home.values())
                for ck in [ck for ck in resident if ck not in live]:
                    del resident[ck]
                used = {tuple(chunk) for _, chunk in plan}
                for ck in [ck for ck in batch_cache if ck not in used]:
                    del batch_cache[ck]
                if fast_losses:
                    with span("nano.round.collect"):
                        all_mets = client_lib.loss_metrics_deferred(
                            [a for _, a, _ in fast_losses], [kk for _, _, kk in fast_losses])
                    for (chunk, _, _), mets in zip(fast_losses, all_mets):
                        for c, m in zip(chunk, mets):
                            losses[c] = m["loss_mean"]

            with span("nano.round.merge", device=True):
                if fast_pend:
                    # the stacked merge: fold where the outputs lie, finalize, commit
                    # with the per-client path's byte totals (k rows of row bytes)
                    prev_global = server.global_adapters
                    acc = strat.agg_stream_fold_stacked(None, [f[0] for f in fast_pend],
                                                        [f[1] for f in fast_pend],
                                                        [f[2] for f in fast_pend],
                                                        use_pallas=use_pallas)
                    server = server_lib.server_commit(
                        server, strat.agg_stream_finalize(acc, use_pallas=use_pallas),
                        param_up=fast_bytes["param_up"], fisher_up=fast_bytes["fisher_up"],
                        param_down=down_bytes, wire_up=wire_up)
                    if server_opt is not None:
                        new_global, opt_state = server_opt.apply(opt_state, prev_global,
                                                                 server.global_adapters)
                        server = dataclasses.replace(server, global_adapters=new_global)
                elif strat.aggregates and (updates or stream_buf or folded_any):
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

            # round metrics in cohort order, whatever order the engine ran them
            round_losses = [losses[c] for c in cohort if c in losses]
            n = len(round_losses)
            # an empty cohort is not a perfect round: mean_loss None, never 0.0
            rm = {"round": r, "mean_loss": sum(round_losses) / n if n else None, "participants": n}
            if failures is not None:
                rm["dropped"] = n_dropped
                rm["crashed"] = n_crashed
            result.round_metrics.append(rm)
            if verbose:
                shown = ("skipped (no participants)" if n == 0
                         else f"mean local loss {rm['mean_loss']:.4f}")
                print(f"  [{strat.name}] round {r}: {shown}")
            if ckpt is not None:
                if home and ckpt.would_save(r + 1):
                    materialize()  # a snapshot needs every client's own rows
                ckpt.maybe_save(r + 1, server=server, clients=clients, tstates=tstates,
                                opt_state=opt_state, metrics=result.round_metrics)
    if home:
        materialize()
    if ckpt is not None:
        ckpt.final_save(rounds, server=server, clients=clients, tstates=tstates,
                        opt_state=opt_state, metrics=result.round_metrics)
    result.server_opt_state = opt_state
    return result, server


def _run_buffered(cfg, server, strat, clients, cids, index_of, train_data, hp, transforms,
                  tstates, server_opt, *, rounds, buffer_size, staleness_power, latency_fn,
                  use_pallas, verbose, failures=None, ckpt=None, resume_state=None):
    """FedBuff-style asynchronous engine: merge every ``buffer_size``
    completions (``repro.core.federated._run_buffered``).

    Simulated time runs in integer ticks; ``latency_fn(cid, version)`` says
    how many a client's local run takes (default 1: uniform clients give
    synchronized rounds). A client trains against the global version it
    last downloaded, and its upload merges with weight n_k/(1+τ)^p, τ the
    merges made while it ran. ``rounds`` counts merges.

    Failures act on each dispatch attempt, drawn at its tick: a dropped
    client never downloads and tries again next tick; a crashed one
    downloads (charged), runs its latency, then its upload is lost and it
    is dispatched again; a straggler's completion comes ``straggler_ticks``
    later, so it lands staler.

    Snapshots are taken at tick boundaries once ``checkpoint_every`` merges
    have passed, with the event heap, the live version snapshots and their
    refcounts and the part-filled buffer, so a resumed run pops the
    completions in the order the uninterrupted one would.
    """
    if not strat.aggregates:
        raise ValueError(f"engine='buffered' needs an aggregating strategy; {strat.name!r} "
                         "never merges (local-only)")
    bsize = min(buffer_size if buffer_size else max(1, len(cids) // 2), len(cids))
    if latency_fn is None:
        latency_fn = lambda cid, version: 1  # noqa: E731
    opt_state = server_opt.init(server.global_adapters) if server_opt is not None else None
    result = FederatedResult(strategy=strat.name, engine="buffered")
    gbytes = tree_bytes(server.global_adapters)

    def fresh_acc():
        # per-merge traffic and failure counters, carried in snapshots so a
        # resumed run reports what the uninterrupted one does
        return {"param_up": 0, "fisher_up": 0, "wire_up": 0, "down": 0, "dropped": 0,
                "crashed": 0, "straggled": 0}

    # version -> [global snapshot, in-flight refcount]: clients in flight pin
    # the version they downloaded
    version = 0
    snapshots: Dict[int, list] = {version: [server.global_adapters, 0]}
    events: List[tuple] = []  # (finish tick, cid, version started, kind)
    merges = 0
    acc_up = fresh_acc()
    buffer: List[tuple] = []  # (theta, fisher, size, loss_mean, staleness)

    def dispatch(cid: int, now: int):
        if failures is not None and failures.drops(cid, now):
            # offline this tick: no download, no pin, nothing to upload; retry next tick
            acc_up["dropped"] += 1
            heapq.heappush(events, (now + 1, cid, version, _EV_RETRY))
            return
        if strat.downloads_global(clients[index_of[cid]].rounds_participated):
            acc_up["down"] += gbytes
        lat = max(1, int(latency_fn(cid, version)))
        if failures is not None and failures.straggles(cid, now):
            acc_up["straggled"] += 1
            lat += failures.straggler_ticks
        if failures is not None and failures.crashes(cid, now):
            # downloaded, then died: nothing comes back, no version stays pinned
            acc_up["crashed"] += 1
            heapq.heappush(events, (now + lat, cid, version, _EV_RETRY))
            return
        snapshots[version][1] += 1
        heapq.heappush(events, (now + lat, cid, version, _EV_RUN))

    def state():
        return BufferedState(version=version, events=list(events), snapshots=snapshots,
                             buffer=buffer, acc_up=acc_up)

    if resume_state is not None:
        b = resume_state.buffered
        if b is None:
            raise CheckpointError("checkpoint has no buffered-engine state; it was written by "
                                  "a synchronized engine")
        version = b.version
        snapshots = dict(b.snapshots)
        # the current version's snapshot is the restored global
        snapshots.setdefault(version, [server.global_adapters, 0])
        events = list(b.events)  # a valid heap, restored as it was
        buffer = list(b.buffer)
        acc_up = dict(b.acc_up)
        merges = resume_state.round_idx
        if resume_state.server_opt_state is not None:
            opt_state = resume_state.server_opt_state
        result.round_metrics = list(resume_state.round_metrics)
    else:
        for cid in cids:
            dispatch(cid, 0)

    while merges < rounds:
        if ckpt is not None:
            ckpt.maybe_save(merges, server=server, clients=clients, tstates=tstates,
                            opt_state=opt_state, metrics=result.round_metrics,
                            buffered=state())
        # drain every completion of this tick before dispatching any of them
        # again: a client downloads again only after its upload is acked, by
        # when the server has merged what this tick brought
        now = events[0][0]
        done_this_tick: List[int] = []
        while events and events[0][0] == now and merges < rounds:
            _, cid, v_start, kind = heapq.heappop(events)
            done_this_tick.append(cid)
            if kind != _EV_RUN:
                continue  # a failed attempt, back to be dispatched again
            snap_global = snapshots[v_start][0]
            i = index_of[cid]
            clients[i], metrics = client_lib.local_update(
                cfg, server.backbone, clients[i], train_data[cid], hp, strat, snap_global,
                round_idx=merges)
            theta = strat.post_local_update(clients[i], snap_global, merges)
            ctx = TransformCtx(cid=cid, round_idx=merges)
            theta_wire = None
            for j, t in enumerate(transforms):
                theta, tstates[cid][j], w = t.apply(ctx, theta, snap_global, tstates[cid][j])
                if w is not None:
                    theta_wire = w
            acc_up["wire_up"] += theta_wire if theta_wire is not None else tree_bytes(theta)
            acc_up["param_up"] += tree_bytes(theta)
            if clients[i].fisher is not None:
                acc_up["fisher_up"] += tree_bytes(clients[i].fisher)
            buffer.append((theta, clients[i].fisher, clients[i].n_examples,
                           metrics["loss_mean"], version - v_start))
            snapshots[v_start][1] -= 1
            if snapshots[v_start][1] == 0 and v_start != version:
                del snapshots[v_start]

            if len(buffer) >= bsize:
                weights = [n / (1.0 + tau) ** staleness_power for _, _, n, _, tau in buffer]
                sacc = strat.agg_stream_fold(strat.agg_stream_init(), [b[0] for b in buffer],
                                             [b[1] for b in buffer], weights,
                                             use_pallas=use_pallas)
                merged = strat.agg_stream_finalize(sacc, use_pallas=use_pallas)
                prev_global = server.global_adapters
                server = server_lib.server_commit(
                    server, merged, param_up=acc_up["param_up"], fisher_up=acc_up["fisher_up"],
                    param_down=acc_up["down"], wire_up=acc_up["wire_up"])
                if server_opt is not None:
                    new_global, opt_state = server_opt.apply(opt_state, prev_global,
                                                             server.global_adapters)
                    server = dataclasses.replace(server, global_adapters=new_global)
                blosses = [b[3] for b in buffer]
                bstale = [b[4] for b in buffer]
                rm = {"round": merges, "mean_loss": sum(blosses) / len(blosses),
                      "participants": len(buffer), "mean_staleness": sum(bstale) / len(bstale)}
                if failures is not None:
                    # failed and slow dispatch attempts since the last merge
                    rm["dropped"] = acc_up["dropped"]
                    rm["crashed"] = acc_up["crashed"]
                    rm["straggled"] = acc_up["straggled"]
                result.round_metrics.append(rm)
                if verbose:
                    print(f"  [{strat.name}] merge {merges}: mean loss {rm['mean_loss']:.4f} "
                          f"staleness {rm['mean_staleness']:.2f}")
                merges += 1
                version += 1
                snapshots[version] = [server.global_adapters, 0]
                buffer.clear()
                acc_up = fresh_acc()

        for cid in done_this_tick:
            dispatch(cid, now)

    if ckpt is not None:
        # the exit snapshot lets a later run add merges (resume with more
        # ``rounds``); stopping at ``rounds`` leaves this tick's other
        # completions undrained, so that run continues this schedule rather
        # than replaying a longer one: the mid-run snapshots are the replays
        ckpt.final_save(merges, server=server, clients=clients, tstates=tstates,
                        opt_state=opt_state, metrics=result.round_metrics, buffered=state())
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
