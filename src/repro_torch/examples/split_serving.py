"""Split serving: client-side NanoEdge + server-side frozen backbone decode
(``examples/split_serving.py``).

    PYTHONPATH=src python -m repro_torch.examples.split_serving [--device cpu] [--use-pallas]

Serves a batch of VQA requests the FedNano way: the client embeds the
question tokens, connects the image patches and applies its NanoAdapters;
the server, which alone holds the LLM, runs prefill and then greedy decode,
one token a step, each new token embedded and adapted by the client. Every
tensor that would cross the wire is byte-counted. ``--device`` defaults to
``cuda`` (without a card it raises); ``--use-pallas`` routes the adapters
and attention through the hand-written kernels (``cfg.use_pallas``).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import client as client_lib
from repro_torch.core.adapters import nano_adapter_apply, nanoedge_forward
from repro_torch.data import SyntheticVQA, examples_to_batches
from repro_torch.models import model as model_lib
from repro_torch.strategies import get_strategy
from repro_torch.utils import fmt_bytes, tree_bytes

TINY = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32, d_ff=256,
            frontend_dim=64)
DECODE_STEPS = 4  # after the prefill's token: 5 tokens a request


def tiny_config():
    return get_smoke_config("llava-1.5-7b").with_(**TINY)


def _wait(t: torch.Tensor) -> None:
    """Let the host clock see the device's work on ``t`` end."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


@torch.no_grad()
def run(cfg, *, device, backbone=None, adapters=None):
    """8 requests (``SyntheticVQA`` seed 1), 5 greedy tokens each.

    ``backbone`` defaults to one drawn from seed 0 on ``device``;
    ``adapters`` to the ``fednano`` strategy's ``init_client`` drawn on the
    CPU from seed 1 and moved to ``device``. -> dict(tokens: per
    request its 5 ints, answers, step_logits: the (B, V) logits that chose
    each step's tokens, wire_up, wire_down, backbone_bytes, prefill_s and
    decode_step_s: host seconds of the server's prefill and of each decode
    step, the client's embedding of the new token included).
    """
    if backbone is None:
        backbone = model_lib.init_backbone(cfg, seed=0, device=device)
    if adapters is None:
        client = get_strategy("fednano").init_client(torch.Generator().manual_seed(1),
                                                     cfg, cid=0, n_examples=8)
        adapters = client_lib.to_device(client, device).adapters

    gen = SyntheticVQA(vocab_size=cfg.vocab_size, seq_len=24, frontend_dim=cfg.frontend_dim,
                       n_patches=8)
    batch = examples_to_batches(gen.generate(8, seed=1), batch_size=8, device=device)[0]

    # ---- CLIENT: NanoEdge forward (the only model code the client runs) ----
    embeds, positions, _, _, _ = nanoedge_forward(cfg, backbone, adapters, batch)
    wire_up = tree_bytes(embeds)

    # ---- SERVER: prefill + batched greedy decode over the frozen LLM ----
    capacity = embeds.shape[1] + 8
    t0 = time.perf_counter()
    state, hidden = model_lib.prefill(cfg, backbone, embeds, positions, capacity)
    last = model_lib.logits(cfg, backbone, hidden[:, -1:, :])
    tok = torch.argmax(last[:, 0], dim=-1)
    _wait(tok)
    prefill_s = time.perf_counter() - t0
    generated, step_logits = [tok], [last[:, 0]]
    wire_down = tree_bytes(last)

    kw = dict(rank=cfg.adapter.rank, alpha=cfg.adapter.alpha, use_pallas=cfg.use_pallas)
    decode_step_s = []
    for step in range(DECODE_STEPS):
        t0 = time.perf_counter()
        pos = embeds.shape[1] + step
        # client embeds + adapts the freshly sampled token, ships (B, 1, D) up
        emb = model_lib.embed_tokens(cfg, backbone, tok[:, None])
        emb = nano_adapter_apply(adapters["text"], emb, **kw)
        wire_up += tree_bytes(emb)
        lg, state = model_lib.decode_step(cfg, backbone, emb, state, pos)
        wire_down += tree_bytes(lg)
        tok = torch.argmax(lg[:, 0], dim=-1)
        _wait(tok)
        decode_step_s.append(time.perf_counter() - t0)
        generated.append(tok)
        step_logits.append(lg[:, 0])

    tokens = torch.stack(generated, dim=1).tolist()
    answers = [[gen.tok.decode_answer(t) if gen.tok.is_answer(t) else None for t in row]
               for row in tokens]
    return dict(tokens=tokens, answers=answers, step_logits=step_logits, wire_up=wire_up,
                wire_down=wire_down, backbone_bytes=tree_bytes(backbone), prefill_s=prefill_s,
                decode_step_s=decode_step_s)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--use-pallas", action="store_true",
                    help="run the adapters and attention on the hand-written kernels")
    args = ap.parse_args(argv)

    out = run(tiny_config().with_(use_pallas=args.use_pallas), device=args.device)
    print(f"served batch of {len(out['tokens'])} requests; generated "
          f"{DECODE_STEPS + 1} tokens each:")
    for i, (toks, answers) in enumerate(zip(out["tokens"], out["answers"])):
        print(f"  req {i}: tokens {toks} answers {answers}")
    print(f"wire traffic: client->server {fmt_bytes(out['wire_up'])}, "
          f"server->client {fmt_bytes(int(out['wire_down']))} "
          f"(vs shipping the backbone: {fmt_bytes(out['backbone_bytes'])})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
