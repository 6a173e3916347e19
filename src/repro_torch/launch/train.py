"""Federated training driver of the port (``python -m repro_torch.launch.train``).

The JAX package's ``repro.launch.train`` cut to what the port runs: any
registered strategy (or ``centralized``, the one-client upper bound) on a
smoke-size backbone and the synthetic non-IID VQA corpus, on ``--device``
(default ``cuda``; on the CPU the kernels' plain versions run).
``--engine`` picks the round engine: ``sequential``, ``vmap`` (each
round's cohort folded into one batch, in chunks of ``--agg-chunk``),
``buffered`` (FedBuff-style merges of ``--buffer-size`` completions,
``--straggler-prob`` delaying a completion) or ``sharded`` (the vmap
layout cut over a client mesh of ``--devices`` cards, or logical CPU
shards with ``--device cpu``, two chunks in flight unless
``--no-overlap``). ``--server-opt`` applies a FedOpt step to the merged result,
``--client-frac`` samples that fraction of the clients each round.
``--use-pallas`` routes the adapters and attention (``cfg.use_pallas``) and
the server's Fisher merge (``use_pallas``) through the hand-written kernels,
as the JAX CLI sets both. ``--dropout-prob``/``--crash-prob`` (with
``--failure-seed``) inject seeded client churn. The run snapshots its whole
round state under ``<out>/state`` every ``--checkpoint-every`` rounds and
at the end; ``--resume DIR`` continues from a snapshot (run with the same
flags). Writes the same JSON summary under ``--out`` and the final server
checkpoint under ``<out>/ckpt``, which ``launch.serve --ckpt-root`` serves.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from repro_torch.checkpoint import save_server_checkpoint
from repro_torch.configs import get_smoke_config, list_archs
from repro_torch.core import FailureModel, HyperParams, run_centralized, run_federated
from repro_torch.data import make_federated_data
from repro_torch.strategies import FedAdamOpt, FedAvgMOpt, UniformSampler, available_strategies


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="llava-1.5-7b", choices=list_archs())
    ap.add_argument("--strategy", default="fednano",
                    choices=list(available_strategies()) + ["centralized"])
    ap.add_argument("--server-opt", default=None, choices=["fedavgm", "fedadam"],
                    help="FedOpt server step applied to the merged pseudo-gradient")
    ap.add_argument("--server-lr", type=float, default=None,
                    help="server-optimizer learning rate (default: the opt's own)")
    ap.add_argument("--client-frac", type=float, default=1.0,
                    help="fraction of clients sampled per round (C in C·K)")
    ap.add_argument("--engine", default="sequential",
                    choices=["sequential", "vmap", "sharded", "buffered"],
                    help="round engine: per-client loop, the cohort folded into one batch, "
                         "the same cut over a clients device mesh, or FedBuff-style buffered "
                         "async")
    ap.add_argument("--devices", type=int, default=None,
                    help="mesh size for --engine sharded (default: every visible card; with "
                         "--device cpu, logical CPU shards, default 1)")
    ap.add_argument("--no-overlap", action="store_true",
                    help="turn off the sharded engine's two-deep prepare/compute pipeline")
    ap.add_argument("--buffer-size", type=int, default=None,
                    help="server buffer size for --engine buffered (default: half the clients)")
    ap.add_argument("--clients", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--local-steps", type=int, default=8)
    ap.add_argument("--alpha", type=float, default=1.0)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--rank", type=int, default=None, help="NanoAdapter rank override")
    ap.add_argument("--examples-per-client", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--agg-chunk", type=int, default=None,
                    help="fold the uploads into a streaming merge every N clients (vmap: "
                         "cohorts of N)")
    ap.add_argument("--use-pallas", action="store_true",
                    help="run the adapters, attention and merge on the hand-written kernels")
    ap.add_argument("--out", default="runs/train")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="snapshot the full round state every N rounds under <out>/state "
                         "(0 = only the final snapshot)")
    ap.add_argument("--resume", default=None, metavar="DIR",
                    help="resume from a RunState snapshot directory (the snapshot or its "
                         "parent; LATEST is followed), with the original run's flags")
    ap.add_argument("--dropout-prob", type=float, default=0.0,
                    help="per-round probability a sampled client never starts")
    ap.add_argument("--crash-prob", type=float, default=0.0,
                    help="per-round probability a client dies mid-update (download "
                         "charged, progress lost)")
    ap.add_argument("--straggler-prob", type=float, default=0.0,
                    help="probability a buffered-engine client is delayed")
    ap.add_argument("--failure-seed", type=int, default=0,
                    help="seed of the failure schedule (independent of --seed)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    if args.rank:
        cfg = cfg.with_(adapter=dataclasses.replace(cfg.adapter, rank=args.rank))
    if args.use_pallas:
        cfg = cfg.with_(use_pallas=True)

    print(f"== FedNano driver (PyTorch port): arch={args.arch} (smoke config) "
          f"strategy={args.strategy} K={args.clients} R={args.rounds} α={args.alpha} "
          f"rank={cfg.adapter.rank} device={args.device}")
    train, evald, _ = make_federated_data(
        cfg, n_clients=args.clients, examples_per_client=args.examples_per_client,
        alpha=args.alpha, batch_size=args.batch_size, seq_len=args.seq_len, seed=args.seed,
        device=args.device)
    hp = HyperParams(lr=args.lr, local_steps=args.local_steps)
    t0 = time.time()
    if args.strategy == "centralized":
        res = run_centralized(args.seed, cfg, train, evald,
                              steps=args.rounds * args.local_steps * args.clients, hp=hp,
                              verbose=True, device=args.device)
    else:
        server_opt = None
        if args.server_opt:
            cls = {"fedavgm": FedAvgMOpt, "fedadam": FedAdamOpt}[args.server_opt]
            server_opt = cls(lr=args.server_lr) if args.server_lr is not None else cls()
        sampler = (UniformSampler(frac=args.client_frac, seed=args.seed)
                   if args.client_frac < 1.0 else None)
        failures = None
        if args.dropout_prob or args.crash_prob or args.straggler_prob:
            failures = FailureModel(dropout_prob=args.dropout_prob, crash_prob=args.crash_prob,
                                    straggler_prob=args.straggler_prob,
                                    seed=args.failure_seed)
        res = run_federated(args.seed, cfg, train, evald, strategy=args.strategy,
                            rounds=args.rounds, hp=hp, verbose=True,
                            use_pallas=args.use_pallas, server_opt=server_opt,
                            sampler=sampler, engine=args.engine, agg_chunk=args.agg_chunk,
                            devices=args.devices, overlap=not args.no_overlap,
                            buffer_size=args.buffer_size, failures=failures,
                            checkpoint_dir=os.path.join(args.out, "state"),
                            checkpoint_every=args.checkpoint_every, resume=args.resume,
                            device=args.device)
    dt = time.time() - t0

    os.makedirs(args.out, exist_ok=True)
    summary = {
        "arch": args.arch,
        "strategy": args.strategy,
        "avg_accuracy": res.avg_accuracy,
        "client_accuracy": res.client_accuracy,
        "rounds": res.round_metrics,
        "comm_totals": res.comm_totals,
        "wall_s": dt,
    }
    with open(os.path.join(args.out, f"{args.arch}_{args.strategy}.json"), "w") as f:
        json.dump(summary, f, indent=1)
    if res.server is not None:
        save_server_checkpoint(os.path.join(args.out, "ckpt"), res.server,
                               round_idx=args.rounds, server_opt_state=res.server_opt_state,
                               seed=args.seed)
    print(f"== done in {dt:.1f}s: avg client accuracy {res.avg_accuracy:.4f}")
    print(f"   per-client: { {k: round(v, 4) for k, v in res.client_accuracy.items()} }")
    if res.comm_totals:
        up = res.comm_totals["param_up"] / 1024**2
        print(f"   param-plane traffic: {up:.2f} MiB up over {args.rounds} rounds")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
