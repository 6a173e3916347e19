"""Full round-state snapshots of the port (``repro.checkpoint.run_state``):
everything a federated run needs to resume.

``save_server_checkpoint`` keeps the model; a killed run also loses the
ServerOpt moments, every client's AdamW state and error-feedback
residuals, the comm log and the round metrics. ``RunState`` holds all of
it, so "run R rounds" and "run r, kill, resume, run R − r" give the same
numbers.

On-disk layout (one directory a snapshot), the JAX package's:

    meta.json       format_version, engine / strategy / hp identity, per-client
                    presence flags, round metrics, comm log, buffered-engine
                    bookkeeping, and a nonce
    run_state.npz   every array leaf, path-keyed under fixed prefixes:
                      rng_key                  the run's seed (``seed_key``:
                                               uint32 (2,), the JAX key's shape)
                      global/...               θ_global
                      sopt/...                 ServerOpt moments
                      client/<i>/adapters/...  per-client trees (opt/, local/,
                                               lopt/, fisher/ beside them)
                      tstate/<i>/<j>/...       transform residuals
                      bsnap/<v>/...            buffered: live version globals
                      bbuf/<n>/theta|fisher/.. buffered: unmerged uploads
                      __nonce__                torn-write detector

``meta.json`` is written last and carries the nonce of the npz: a save cut
short leaves no meta (unreadable) or a nonce mismatch (refused), never a
half-restored run. ``BufferedState`` and the ``bsnap``/``bbuf`` entries are
the buffered engine's.

A JAX-written snapshot loads (``load_run_state`` reads its ``rng_key`` and
checks nothing of it, as the JAX package does); resuming one is refused,
because its key is not the port's ``seed_key`` (``core/federated.py``).
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.checkpoint.io import (CheckpointError, CheckpointVersionError,
                                       flatten_pytree, savez, unflatten_pytree)

RUN_STATE_VERSION = 1

_NONCE_KEY = "__nonce__"


@dataclass
class BufferedState:
    """Buffered-engine bookkeeping at a tick boundary: the completion heap as
    a list, live version snapshots (adapters, in-flight refcount), unmerged
    uploads (theta, fisher, n_examples, loss_mean, staleness)."""

    version: int = 0
    events: List[tuple] = field(default_factory=list)
    snapshots: Dict[int, list] = field(default_factory=dict)
    buffer: List[tuple] = field(default_factory=list)
    acc_up: Dict[str, int] = field(default_factory=dict)


@dataclass
class RunState:
    """A complete, versioned snapshot of a ``run_federated`` run."""

    engine: str
    strategy: str
    round_idx: int                 # rounds completed
    server_round_idx: int          # ServerState.round_idx (commit counter)
    rng_key: Any                   # seed_key(seed): the resume identity check
    global_adapters: Any
    server_opt_state: Any = None
    clients: List[Any] = field(default_factory=list)        # ClientState list
    tstates: List[List[Any]] = field(default_factory=list)  # [client][transform]
    round_metrics: List[dict] = field(default_factory=list)
    comm_rounds: List[dict] = field(default_factory=list)
    buffered: Optional[BufferedState] = None
    meta_extra: Dict[str, Any] = field(default_factory=dict)  # hp, cfg, ...


def _client_meta(c) -> dict:
    return {"cid": c.cid, "n_examples": c.n_examples,
            "rounds_participated": c.rounds_participated,
            "has_fisher": c.fisher is not None,
            "has_local": c.local_adapters is not None,
            "has_local_opt": c.local_opt_state is not None}


def save_run_state(dirpath: str, rs: RunState) -> None:
    os.makedirs(dirpath, exist_ok=True)
    nonce = f"{rs.engine}:{rs.round_idx}:{rs.server_round_idx}:{len(rs.comm_rounds)}"
    arrays: Dict[str, np.ndarray] = {}

    def put(prefix, tree):
        if tree is not None:
            arrays.update(flatten_pytree(tree, prefix=prefix))

    put("rng_key", np.asarray(rs.rng_key))
    put("global", rs.global_adapters)
    put("sopt", rs.server_opt_state)
    for i, c in enumerate(rs.clients):
        put(f"client/{i}/adapters", c.adapters)
        put(f"client/{i}/opt", c.opt_state)
        put(f"client/{i}/local", c.local_adapters)
        put(f"client/{i}/lopt", c.local_opt_state)
        put(f"client/{i}/fisher", c.fisher)
    for i, per_client in enumerate(rs.tstates):
        for j, st in enumerate(per_client):
            put(f"tstate/{i}/{j}", st)

    buffered_meta = None
    if rs.buffered is not None:
        b = rs.buffered
        for v, (snap, _) in sorted(b.snapshots.items()):
            put(f"bsnap/{v}", snap)
        buf_meta = []
        for n, (theta, fisher, n_ex, loss, stale) in enumerate(b.buffer):
            put(f"bbuf/{n}/theta", theta)
            put(f"bbuf/{n}/fisher", fisher)
            buf_meta.append({"n_examples": int(n_ex), "loss_mean": float(loss),
                             "staleness": int(stale), "has_fisher": fisher is not None})
        buffered_meta = {
            "version": b.version,
            "events": [list(e) for e in b.events],
            "snapshot_refcounts": {str(v): int(rc) for v, (_, rc) in b.snapshots.items()},
            "buffer": buf_meta,
            "acc_up": dict(b.acc_up),
        }

    arrays[_NONCE_KEY] = np.frombuffer(nonce.encode(), dtype=np.uint8)
    savez(os.path.join(dirpath, "run_state.npz"), arrays)

    meta = {
        "format_version": RUN_STATE_VERSION,
        "nonce": nonce,
        "engine": rs.engine,
        "strategy": rs.strategy,
        "round_idx": rs.round_idx,
        "server_round_idx": rs.server_round_idx,
        "n_clients": len(rs.clients),
        "clients": [_client_meta(c) for c in rs.clients],
        "n_transforms": len(rs.tstates[0]) if rs.tstates else 0,
        "tstate_present": [[st is not None for st in per_client] for per_client in rs.tstates],
        "has_server_opt_state": rs.server_opt_state is not None,
        "round_metrics": rs.round_metrics,
        "comm_rounds": rs.comm_rounds,
        "buffered": buffered_meta,
    }
    meta.update(rs.meta_extra)
    # meta.json last: no meta, no checkpoint
    with open(os.path.join(dirpath, "meta.json"), "w") as f:
        json.dump(meta, f)


def read_run_meta(dirpath: str) -> dict:
    """A snapshot's meta.json, version-checked (arrays untouched)."""
    meta_path = os.path.join(dirpath, "meta.json")
    if not os.path.exists(meta_path):
        raise CheckpointError(f"no run-state checkpoint at {dirpath!r} (meta.json missing)")
    with open(meta_path) as f:
        meta = json.load(f)
    version = meta.get("format_version")
    if version != RUN_STATE_VERSION:
        raise CheckpointVersionError(
            f"run-state checkpoint at {dirpath!r} has format_version={version!r}, this code "
            f"reads v{RUN_STATE_VERSION}; refusing to mis-restore")
    return meta


def resolve_run_state_dir(path: str) -> str:
    """A snapshot directory, or a checkpoint root whose LATEST names one."""
    if os.path.exists(os.path.join(path, "meta.json")):
        return path
    latest = os.path.join(path, "LATEST")
    if os.path.exists(latest):
        with open(latest) as f:
            name = f.read().strip()
        cand = os.path.join(path, name)
        if os.path.exists(os.path.join(cand, "meta.json")):
            return cand
        raise CheckpointError(f"{latest} points at {name!r} but {cand!r} has no meta.json")
    raise CheckpointError(f"no run-state checkpoint at {path!r} (neither meta.json nor LATEST)")


def load_run_state(dirpath: str, *, clients_ref: Sequence[Any], global_ref,
                   server_opt_state_ref=None,
                   transform_templates: Optional[Sequence[Any]] = None) -> RunState:
    """Restore a :class:`RunState` against freshly initialized references.

    ``clients_ref`` are the ClientStates a fresh run builds (same seed, same
    strategy): they give the structures, and every leaf is overwritten.
    ``transform_templates[j]`` is ``transforms[j].state_template(global)``.
    The optional pieces (Fisher, the personal adapters' optimizer, transform
    residuals) are restored by the presence flags written at save time.
    """
    from repro_torch.core.client import client_ref_like

    meta = read_run_meta(dirpath)
    with np.load(os.path.join(dirpath, "run_state.npz"), allow_pickle=False) as npz:
        data = {k: npz[k] for k in npz.files}

    nonce = bytes(data[_NONCE_KEY]).decode() if _NONCE_KEY in data else None
    if nonce != meta.get("nonce"):
        raise CheckpointError(
            f"torn checkpoint at {dirpath!r}: meta.json nonce {meta.get('nonce')!r} != "
            f"archive nonce {nonce!r} (the save was interrupted between the two files)")
    if len(clients_ref) != meta["n_clients"]:
        raise CheckpointError(f"checkpoint at {dirpath!r} holds {meta['n_clients']} clients, "
                              f"the run was set up with {len(clients_ref)}")

    where = os.path.basename(dirpath.rstrip(os.sep)) or dirpath

    def get(prefix, ref):
        return unflatten_pytree(ref, data, prefix=prefix, where=where)

    global_adapters = get("global", global_ref)
    server_opt_state = None
    if meta["has_server_opt_state"]:
        if server_opt_state_ref is None:
            raise CheckpointError(
                f"checkpoint at {dirpath!r} carries ServerOpt moments but no reference "
                "structure was provided — resuming without them would silently reset the "
                "server optimizer")
        server_opt_state = get("sopt", server_opt_state_ref)

    clients = []
    for i, (cref, cmeta) in enumerate(zip(clients_ref, meta["clients"])):
        if cref.cid != cmeta["cid"]:
            raise CheckpointError(f"client {i} mismatch: checkpoint cid {cmeta['cid']}, "
                                  f"reference cid {cref.cid} (different data partition?)")
        if cmeta["has_local"] != (cref.local_adapters is not None):
            raise CheckpointError(
                f"client {cmeta['cid']}: checkpoint "
                f"{'has' if cmeta['has_local'] else 'lacks'} personal adapters but the "
                "configured strategy disagrees")
        ref = client_ref_like(cref)
        clients.append(dataclasses.replace(
            cref,
            adapters=get(f"client/{i}/adapters", ref.adapters),
            opt_state=get(f"client/{i}/opt", ref.opt_state),
            local_adapters=(get(f"client/{i}/local", ref.local_adapters)
                            if cmeta["has_local"] else None),
            local_opt_state=(get(f"client/{i}/lopt", ref.local_opt_state)
                             if cmeta["has_local_opt"] else None),
            fisher=get(f"client/{i}/fisher", ref.fisher) if cmeta["has_fisher"] else None,
            rounds_participated=cmeta["rounds_participated"],
            n_examples=cmeta["n_examples"]))

    tstates: List[List[Any]] = []
    for i, present in enumerate(meta["tstate_present"]):
        per_client: List[Any] = []
        for j, has in enumerate(present):
            if not has:
                per_client.append(None)
                continue
            tmpl = (transform_templates[j] if transform_templates is not None
                    and j < len(transform_templates) else None)
            if tmpl is None:
                raise CheckpointError(
                    f"checkpoint at {dirpath!r} carries state for transform #{j} but the "
                    "transform provides no state_template(); implement it to make the "
                    "transform resumable")
            per_client.append(get(f"tstate/{i}/{j}", tmpl))
        tstates.append(per_client)

    buffered = None
    if meta.get("buffered") is not None:
        bm = meta["buffered"]
        fisher_tmpl = client_ref_like(clients_ref[0]).fisher
        snapshots = {int(v): [get(f"bsnap/{v}", global_ref), rc]
                     for v, rc in bm["snapshot_refcounts"].items()}
        buffer = [(get(f"bbuf/{n}/theta", global_ref),
                   get(f"bbuf/{n}/fisher", fisher_tmpl) if ent["has_fisher"] else None,
                   ent["n_examples"], ent["loss_mean"], ent["staleness"])
                  for n, ent in enumerate(bm["buffer"])]
        buffered = BufferedState(version=bm["version"], events=[tuple(e) for e in bm["events"]],
                                 snapshots=snapshots, buffer=buffer, acc_up=dict(bm["acc_up"]))

    known = {"format_version", "nonce", "engine", "strategy", "round_idx", "server_round_idx",
             "n_clients", "clients", "n_transforms", "tstate_present", "has_server_opt_state",
             "round_metrics", "comm_rounds", "buffered"}
    return RunState(
        engine=meta["engine"], strategy=meta["strategy"], round_idx=meta["round_idx"],
        server_round_idx=meta["server_round_idx"], rng_key=np.asarray(data["rng_key"]),
        global_adapters=global_adapters, server_opt_state=server_opt_state, clients=clients,
        tstates=tstates, round_metrics=meta["round_metrics"], comm_rounds=meta["comm_rounds"],
        buffered=buffered, meta_extra={k: v for k, v in meta.items() if k not in known})
