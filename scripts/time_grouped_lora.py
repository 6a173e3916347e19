#!/usr/bin/env python3
"""Time the port's grouped-LoRA kernel on one NVIDIA card, warm and cold.

    python3 scripts/time_grouped_lora.py [--src DIR] [--label NAME] [--out FILE] [--trace]
    python3 scripts/time_grouped_lora.py --serve ARCH [--repeat N] [--src DIR]

Builds the kernels of the ``repro_torch`` package under ``--src`` (default:
this checkout's ``src``; point it at the ``src`` of another checkout to time
that tree's kernel on the same card), checks the kernel against its plain
version at each shape, and times it with ``chip_smoke.py``'s helpers
(``time_ms``: 50 calls replayed from one CUDA graph on the same inputs;
``time_ms_cold``: the calls rotate over copies of the inputs so that more
than 100 MB pass between two uses of a copy). Shapes: llava-1.5-7b's decode
step, x (8, 4096) bf16 into an (8, 4096, 64) f32 bank with 1, 4 and 8
adapters in use, and mamba2-130m's, x (8, 768), 4 in use. Prints one JSON
line per shape (and appends it to ``--out``), with the card's name and
power limit. ``--trace`` also prints, per shape, the device timeline of
three calls replayed from a CUDA graph (torch.profiler): each CUDA kernel's
start and end in microseconds from the first kernel's start.

``--serve ARCH`` instead runs ``chip_smoke.py``'s full-width serving run of
ARCH (16 requests from 4 tenants and base traffic, random weights from a
seed) ``--repeat`` times with the tree's kernels and prints its ``[serve]``
line each time (decode step ms, tokens/s): the end-to-end numbers of two
trees, taken in turns within one call on one card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [
    # (label, D, ids)
    ("llava 4 in use", 4096, [0, 1, 2, 3, 0, 1, 2, -1]),
    ("llava 1 in use", 4096, [0, 0, 0, 0, 0, 0, 0, -1]),
    ("llava 8 in use", 4096, list(range(8))),
    ("mamba2 4 in use", 768, [0, 1, 2, 3, 0, 1, 2, -1]),
]


def timeline(torch, fn, what, calls: int = 3) -> None:
    """Print the device timeline of ``calls`` calls of ``fn`` replayed from one
    CUDA graph: kernel name, start and end in us from the first start."""
    from torch.profiler import ProfilerActivity, profile

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        print(f"[trace] {what}: no device activity recorded", flush=True)
        return
    t0 = spans[0][0]
    parts = [f"{name.replace('(anonymous namespace)::', '').split('(')[0][-24:]} "
             f"{a - t0:.2f}-{b - t0:.2f}" for a, b, name in spans]
    print(f"[trace] {what}: " + "; ".join(parts), flush=True)


def serve(torch, cs, args, card) -> int:
    """chip_smoke.serving_full of args.serve, args.repeat times."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.fisher_merge import ops as fm_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.lora import ops as lora_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch.serve import make_requests, synth_tenant_adapters
    from repro_torch.models.model import init_backbone
    from repro_torch.serving import ServingEngine

    counters = {"lora_residual": lora_ops.lora_residual,
                "grouped_lora_residual": lora_ops.grouped_lora_residual,
                "flash_attention": fa_ops.flash_attention, "fisher_merge": fm_ops.fisher_merge,
                "fisher_fold": fm_ops.fisher_fold, "ssd_scan": ssd_ops.ssd}
    print(f"[{args.label}] {card}", flush=True)
    for _ in range(args.repeat):
        cs.serving_full(torch, get_config, init_backbone, synth_tenant_adapters, make_requests,
                        ServingEngine, counters, arch=args.serve)
        torch.cuda.empty_cache()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out", default=None)
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--serve", default=None, help="an arch: time serving instead")
    ap.add_argument("--repeat", type=int, default=1)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_grouped_lora: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.lora import ops, ref

    build.library()
    card = cs.card_line()
    if args.serve:
        return serve(torch, cs, args, card)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    r, n = 64, 8
    lines = []
    for label, d, ids in SHAPES:
        x = torch.randn((len(ids), d), generator=gen, device=dev).to(torch.bfloat16)
        down = torch.randn((n, d, r), generator=gen, device=dev) * 0.05
        up = torch.randn((n, r, d), generator=gen, device=dev) * 0.05
        idx = torch.tensor(ids, dtype=torch.int32, device=dev)
        y = ops.grouped_lora_residual(x, down, up, idx, scale=cs.SCALE)
        want = ref.grouped_lora_residual(x, down, up, idx, scale=cs.SCALE)
        err = float((y.float() - want.float()).abs().max())
        used = len({i for i in ids if 0 <= i < n})
        live = sum(0 <= i < n for i in ids)
        n_bytes = cs.nbytes(x, y, idx) + used * cs.nbytes(down[0], up[0])
        b_ms, b_by = cs.bound(n_bytes, (4 * r + 2) * live * d, "f32")
        warm, _ = cs.time_ms(torch, lambda: ops.grouped_lora_residual(x, down, up, idx,
                                                                      scale=cs.SCALE))
        cold = cs.time_ms_cold(torch, lambda *a: ops.grouped_lora_residual(*a, scale=cs.SCALE),
                               (x, down, up, idx), n_bytes)
        row = dict(tree=args.label, shape=label, x=[len(ids), d], ids=ids, in_use=used,
                   warm_ms=warm, cold_ms=cold, bound_ms=b_ms, bound_by=b_by,
                   max_abs_err_vs_plain=err, card=card)
        lines.append(json.dumps(row))
        print(lines[-1], flush=True)
        if args.trace:
            timeline(torch, lambda: ops.grouped_lora_residual(x, down, up, idx, scale=cs.SCALE),
                     f"{args.label} {label}")
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
