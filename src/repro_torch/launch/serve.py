"""Multi-tenant serving driver of the port (``python -m repro_torch.launch.serve``).

The same CLI as ``repro.launch.serve``: one frozen smoke-size backbone
serves many tenants, each a federated client whose NanoAdapters sit in the
engine's adapter bank, with continuous batching over a fixed page pool.
Tenant adapters are synthesized from ``--seed``. ``--device`` (default
``cuda``) picks the card; on the CPU the kernels' plain versions run.

``--ckpt-root`` (federated checkpoints) and ``--naive`` (the one-request-at-
a-time baseline) wait for the checkpoint and ``generate_naive`` ports
(ROADMAP queue 4).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config, list_archs
from repro_torch.models import model as backbone_lib
from repro_torch.models.layers import torch_dtype
from repro_torch.models.vision_stub import num_patches
from repro_torch.serving import Request, ServingEngine


def synth_tenant_adapters(seed: int, cfg, tenants, device):
    """Deterministic non-identity adapter sets, one per tenant name, drawn
    N(0, 0.05²) from a seeded generator on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed + 100)
    dtype = torch_dtype(cfg.adapter.dtype)
    d, r = cfg.d_model, cfg.adapter.rank
    out = {}
    for t in tenants:
        out[t] = {
            mod: {name: torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
                  .mul_(0.05).to(dtype)
                  for name, shape in (("down", (d, r)), ("up", (r, d)))}
            for mod in cfg.adapter.modalities
        }
    return out


def make_requests(cfg, tenants, n_requests, prefill_len, gen_tokens, seed):
    """Mixed workload: tenants round-robin (every 5th request tenantless),
    prompt lengths cycling through [2, prefill_len]."""
    rng = np.random.default_rng(seed)
    m = num_patches(cfg) if cfg.frontend_dim else 0
    reqs = []
    for i in range(n_requests):
        tenant = None if (i % 5 == 4) else tenants[i % len(tenants)]
        length = 2 + (i * 3) % (prefill_len - 1)
        patches = (rng.standard_normal((m, cfg.frontend_dim)).astype(np.float32)
                   if cfg.frontend_dim else None)
        reqs.append(Request(
            rid=i, tenant=tenant,
            prompt=rng.integers(0, cfg.vocab_size, length).astype(np.int32),
            patches=patches, max_new_tokens=gen_tokens))
    return reqs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="llava-1.5-7b", choices=list_archs())
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--gen-tokens", type=int, default=8)
    ap.add_argument("--prefill-len", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4,
                    help="concurrent decode slots (page pool size)")
    ap.add_argument("--adapter-slots", type=int, default=8,
                    help="adapter bank size (LRU over tenants)")
    ap.add_argument("--pallas-grouped", action="store_true",
                    help="run the grouped-LoRA kernel in the decode step "
                         "instead of its plain version")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    backbone = backbone_lib.init_backbone(cfg, seed=args.seed, device=args.device)
    tenant_names = [f"tenant{i}" for i in range(args.tenants)]
    adapters_by_tenant = synth_tenant_adapters(args.seed, cfg, tenant_names, args.device)
    print(f"serving {len(tenant_names)} synthetic tenants on {args.device}")

    reqs = make_requests(cfg, tenant_names, args.requests, args.prefill_len,
                         args.gen_tokens, args.seed)
    engine = ServingEngine(
        cfg, backbone, max_slots=args.slots, prefill_len=args.prefill_len,
        max_new_tokens=args.gen_tokens, adapter_slots=args.adapter_slots,
        adapter_loader=adapters_by_tenant.__getitem__,
        use_pallas_grouped=args.pallas_grouped)

    t0 = time.perf_counter()
    done = engine.run(reqs)
    dt = time.perf_counter() - t0
    n_tok = sum(len(c.tokens) for c in done.values())
    print(f"arch={args.arch} engine: {len(reqs)} requests, {n_tok} tokens "
          f"in {dt:.2f}s ({n_tok / dt:.1f} tok/s on {args.device}) | "
          f"occupancy {engine.mean_occupancy():.2f}/{args.slots} | "
          f"adapter cache {engine.cache.stats()}")
    for rid in sorted(done)[:4]:
        c = done[rid]
        print(f"  req {rid} [{c.tenant or 'base'}]: {c.tokens}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
