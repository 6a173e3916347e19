"""Federated training driver of the port (``python -m repro_torch.launch.train``).

The JAX package's ``repro.launch.train`` cut to what the port runs: FedNano
with the sequential engine on a smoke-size backbone and the synthetic non-IID
VQA corpus, on ``--device`` (default ``cuda``; on the CPU the kernels' plain
versions run). ``--use-pallas`` routes the adapters and attention
(``cfg.use_pallas``) and the server's merge (``use_pallas``) through the
hand-written kernels, as the JAX CLI sets both. Writes the same JSON summary
under ``--out``. Checkpoint saving waits for ROADMAP queue 5; the other
strategies, engines and options for queues 2 and 5.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from repro_torch.configs import get_smoke_config, list_archs
from repro_torch.core import HyperParams, run_federated
from repro_torch.data import make_federated_data


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="llava-1.5-7b", choices=list_archs())
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
                    help="fold the uploads into a streaming merge every N clients")
    ap.add_argument("--use-pallas", action="store_true",
                    help="run the adapters, attention and merge on the hand-written kernels")
    ap.add_argument("--out", default="runs/train")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    if args.rank:
        cfg = cfg.with_(adapter=dataclasses.replace(cfg.adapter, rank=args.rank))
    if args.use_pallas:
        cfg = cfg.with_(use_pallas=True)

    print(f"== FedNano driver (PyTorch port): arch={args.arch} (smoke config) "
          f"strategy=fednano K={args.clients} R={args.rounds} α={args.alpha} "
          f"rank={cfg.adapter.rank} device={args.device}")
    train, evald, _ = make_federated_data(
        cfg, n_clients=args.clients, examples_per_client=args.examples_per_client,
        alpha=args.alpha, batch_size=args.batch_size, seq_len=args.seq_len, seed=args.seed,
        device=args.device)
    hp = HyperParams(lr=args.lr, local_steps=args.local_steps)
    t0 = time.time()
    res = run_federated(args.seed, cfg, train, evald, strategy="fednano", rounds=args.rounds,
                        hp=hp, verbose=True, use_pallas=args.use_pallas,
                        agg_chunk=args.agg_chunk, device=args.device)
    dt = time.time() - t0

    os.makedirs(args.out, exist_ok=True)
    summary = {
        "arch": args.arch,
        "strategy": "fednano",
        "avg_accuracy": res.avg_accuracy,
        "client_accuracy": res.client_accuracy,
        "rounds": res.round_metrics,
        "comm_totals": res.comm_totals,
        "wall_s": dt,
    }
    with open(os.path.join(args.out, f"{args.arch}_fednano.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"== done in {dt:.1f}s: avg client accuracy {res.avg_accuracy:.4f}")
    print(f"   per-client: { {k: round(v, 4) for k, v in res.client_accuracy.items()} }")
    up = res.comm_totals["param_up"] / 1024**2
    print(f"   param-plane traffic: {up:.2f} MiB up over {args.rounds} rounds")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
