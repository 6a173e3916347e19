"""Quickstart: tune NanoAdapters against a frozen backbone (``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu] [--use-pallas]

Builds a reduced LLaVA-style backbone (frozen), attaches NanoEdge (trainable
text and image adapters), and runs a short local tuning loop on synthetic
VQA triplets: the client-side experience of FedNano. ``--device`` defaults
to ``cuda`` (without a card it raises); ``--use-pallas`` routes the adapters
and attention through the hand-written kernels (``cfg.use_pallas``).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import client as client_lib
from repro_torch.core.adapters import adapter_param_count, fednano_loss
from repro_torch.data import SyntheticVQA, examples_to_batches
from repro_torch.models.model import init_backbone
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.strategies import get_strategy

TINY = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32, d_ff=256,
            frontend_dim=64)
EPOCHS = 6


def tiny_config():
    return get_smoke_config("llava-1.5-7b").with_(**TINY)


def run(cfg, *, device, backbone=None, adapters=None, epochs: int = EPOCHS):
    """The FedNano local objective on NanoEdge: AdamW steps on the adapters
    alone, the example's 8 batches of 8 an epoch.

    ``backbone`` defaults to one drawn from seed 0 on ``device``;
    ``adapters`` to the ``fednano`` strategy's ``init_client`` drawn on the
    CPU from seed 1 and moved to ``device`` (fresh AdamW state either
    way). -> dict(param_count, epoch_losses, step_s: each step's host
    seconds, ending where ``float(loss)`` waits for the device).
    """
    if backbone is None:
        backbone = init_backbone(cfg, seed=0, device=device)
    if adapters is None:
        client = get_strategy("fednano").init_client(torch.Generator().manual_seed(1),
                                                     cfg, cid=0, n_examples=64)
        adapters = client_lib.to_device(client, device).adapters
    opt_state = adamw_init(adapters)

    gen = SyntheticVQA(vocab_size=cfg.vocab_size, seq_len=24, frontend_dim=cfg.frontend_dim,
                       n_patches=8)
    batches = examples_to_batches(gen.generate(64, seed=0), batch_size=8, device=device)

    def step(adapters, opt_state, batch):
        loss, _, grads = client_lib.value_and_grad(
            lambda a: fednano_loss(cfg, backbone, a, batch), adapters)
        adapters, opt_state = adamw_update(grads, opt_state, adapters, lr=5e-3)
        return adapters, opt_state, loss

    epoch_losses, step_s = [], []
    for _ in range(epochs):
        losses = []
        for b in batches:
            t0 = time.perf_counter()
            adapters, opt_state, loss = step(adapters, opt_state, b)
            losses.append(float(loss))
            step_s.append(time.perf_counter() - t0)
        epoch_losses.append(sum(losses) / len(losses))
    return dict(param_count=adapter_param_count(cfg), epoch_losses=epoch_losses, step_s=step_s)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--use-pallas", action="store_true",
                    help="run the adapters and attention on the hand-written kernels")
    args = ap.parse_args(argv)

    out = run(tiny_config().with_(use_pallas=args.use_pallas), device=args.device)
    print(f"backbone frozen; trainable adapter params: {out['param_count']:,}")
    for epoch, loss in enumerate(out["epoch_losses"]):
        print(f"epoch {epoch}: loss {loss:.4f}")
    print("done — adapters are the ONLY thing that changed (and the only "
          "thing a FedNano client would upload).")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
