"""End-to-end federated driver: FedNano vs FedAvg vs LocFT on non-IID VQA
(``examples/federated_vqa.py``).

    PYTHONPATH=src python -m repro_torch.examples.federated_vqa [--rounds 5] [--clients 5] \\
        [--device cpu] [--use-pallas]

Runs the full Alg.-1 protocol (a Dirichlet(α) split over a synthetic
multimodal corpus, per-round local NanoAdapter tuning, diagonal-FIM
estimation, Fisher-merged aggregation) for each strategy and prints the
per-client accuracy table and the communication ledger. ``--device``
defaults to ``cuda`` (without a card it raises); ``--use-pallas``
(``cfg.use_pallas``) routes the adapters, the attention and the server's
Fisher merge through the hand-written kernels.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch.configs import get_smoke_config
from repro_torch.core import HyperParams, run_federated
from repro_torch.core.comm import CommLog
from repro_torch.data import make_federated_data
from repro_torch.strategies import available_strategies, get_strategy
from repro_torch.utils import fmt_bytes

DIMS = dict(tiny=dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32, d_ff=256,
                      frontend_dim=64, vocab_size=512),
            small=dict(n_layers=4, d_model=320, n_heads=8, n_kv_heads=8, head_dim=40,
                       d_ff=1280, frontend_dim=128, vocab_size=16384))
STRATEGIES = ("locft", "fedavg", "fednano")


def scale_config(scale: str = "tiny"):
    return get_smoke_config("llava-1.5-7b").with_(**DIMS[scale])


def run(cfg, *, device, strategies=STRATEGIES, rounds: int = 4, clients: int = 5,
        local_steps: int = 6, alpha: float = 1.0, server=None, verbose: bool = True):
    """Each strategy's ``run_federated`` on one non-IID split (48 examples a
    client, batches of 8 x 24 tokens), every run from the same server: the
    one ``run_federated`` draws from seed 0, or ``server`` (each run gets it
    with an empty comm log). ``verbose`` prints the round lines and each
    strategy's average accuracy and seconds as it ends.
    -> dict(results: name -> FederatedResult, wall_s: name -> seconds,
    ledger_name, ledger: that strategy's comm totals)."""
    # resolve every name up front so a typo fails before any training time
    strats = [get_strategy(n) for n in strategies]
    train, evald, _ = make_federated_data(cfg, n_clients=clients, examples_per_client=48,
                                          alpha=alpha, batch_size=8, seq_len=24, device=device)
    hp = HyperParams(lr=5e-3, local_steps=local_steps, fisher_batches=2)
    results, wall_s = {}, {}
    for strategy in strats:
        t0 = time.time()
        res = run_federated(0, cfg, train, evald, strategy=strategy, rounds=rounds, hp=hp,
                            verbose=verbose, use_pallas=cfg.use_pallas, device=device,
                            server=None if server is None else dataclasses.replace(
                                server, comm=CommLog(), round_idx=0))
        results[strategy.name], wall_s[strategy.name] = res, time.time() - t0
        if verbose:
            print(f"  -> {strategy.name}: avg acc {100*res.avg_accuracy:.2f}% "
                  f"({wall_s[strategy.name]:.0f}s)")
    ledger_name = "fednano" if "fednano" in results else next(reversed(results))
    return dict(results=results, wall_s=wall_s, ledger_name=ledger_name,
                ledger=results[ledger_name].comm_totals)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--clients", type=int, default=5)
    ap.add_argument("--local-steps", type=int, default=6)
    ap.add_argument("--alpha", type=float, default=1.0)
    ap.add_argument("--strategies", default=",".join(STRATEGIES),
                    help=f"comma-separated registry names; registered: "
                         f"{', '.join(available_strategies())}")
    ap.add_argument("--scale", choices=["tiny", "small"], default="tiny",
                    help="small ≈ 25M backbone (slower; a few hundred total steps)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--use-pallas", action="store_true",
                    help="run the adapters, attention and merge on the hand-written kernels")
    args = ap.parse_args(argv)

    cfg = scale_config(args.scale).with_(use_pallas=args.use_pallas)
    total_steps = args.rounds * args.clients * args.local_steps
    print(f"== federated VQA: K={args.clients} R={args.rounds} T={args.local_steps} "
          f"(≈{total_steps} local steps/strategy), α={args.alpha}, scale={args.scale}")
    out = run(cfg, device=args.device, strategies=[n.strip() for n in args.strategies.split(",")],
              rounds=args.rounds, clients=args.clients, local_steps=args.local_steps,
              alpha=args.alpha)
    results = out["results"]

    print("\nper-client accuracy (%):")
    cids = sorted(next(iter(results.values())).client_accuracy)
    print("strategy    " + "".join(f"C{c+1:<7}" for c in cids) + "avg")
    for s, res in results.items():
        cells = "".join(f"{100*res.client_accuracy[c]:<8.2f}" for c in cids)
        print(f"{s:<12}{cells}{100*res.avg_accuracy:.2f}")

    ct = out["ledger"]
    print(f"\n{out['ledger_name']} communication ledger over {args.rounds} rounds × "
          f"{args.clients} clients:")
    print(f"  adapter uploads   {fmt_bytes(ct['param_up'])}")
    print(f"  diag-FIM uploads  {fmt_bytes(ct['fisher_up'])}")
    print(f"  merged broadcast  {fmt_bytes(ct['param_down'])}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
