#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout; needs one CUDA card

Phases, in order; any failure ends the run with a non-zero exit code:

1. Print the card's name and power limit; switch TF32 off.
2. Build the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a).
3. Kernel parity: every kernel against its plain PyTorch version on the
   card, f32 and bf16, over the port's copy of the kernel-harness grids and
   the full-width llava-1.5-7b shapes and the bf16 tiles' edges, at the
   harness tolerances; the grouped kernel's rows bit-identical to the
   single-adapter kernel in f32, and its identity rows exactly x. The bf16
   flash and LoRA kernels (tensor cores) also against their rounding models
   at ``harness.BF16_MODEL_TOLERANCES`` (LoRA also at most
   ``harness.LORA_MODEL_MAX_SHARE`` of its elements differing), and, at the
   main-path shapes, against the f32 function beside the exact plain version
   and the models beside the exact plain versions (``[accuracy]``).
4. Smoke-size serving: the engine on the card (kernels, f32) and on the CPU
   (plain versions) give the same tokens and prefill logits.
5. Full-width serving: ``ServingEngine`` on llava-1.5-7b (32 layers,
   d_model 4096, bf16, random weights from a seed) with the three kernels,
   16 requests from 4 tenants and base traffic. Launch counters are reset
   just before this run and read just after it. The same requests then run
   with the kernels replaced by their plain versions, in bf16 and again with
   the same weights upcast to f32: prefill logits must agree within
   LOGIT_TOL. Each bf16 run is also measured against the f32 plain run.
6. Training kernel parity: the fisher_merge and fisher_fold kernels against
   their plain versions (the port's copy of the harness grid plus the
   slice's K=2, N=262,144), and the gradients of the LoRA and flash-attention
   Functions (kernel forward, hand-written backward) against torch.autograd
   through the plain versions, f32 and bf16, including x (128, 4096) and
   (256, 4096) (the text and image rows NanoEdge gives the kernel), x
   (384, 4096) and q/k/v (4, 96, 32, 128).
7. Smoke-size training: two FedNano rounds of smoke llava on the card
   (kernels, f32) and on the CPU (plain versions): round losses, global
   adapters and the first step's loss and adapter gradients within 1e-5,
   comm totals equal.
8. Full-width training, the slice's main path: ``run_federated`` with
   strategy fednano on llava-1.5-7b (32 layers, d_model 4096, bf16 backbone
   from a seed, f32 rank-64 text and image adapters), 2 clients, 2 rounds,
   2 local steps and 2 Fisher batches each, batch 4 of 64 patches + 32 text
   tokens, kernels on (``cfg.use_pallas`` and ``use_pallas``). Launch counters
   are reset just before and read just after. A second run with
   ``agg_chunk=1`` takes round 0 through the fisher_fold kernel, also with its
   counters reset around it; its streamed merge must equal the fisher_merge
   kernel's batch merge of the same uploads to f32 summation order.
9. Full-width kernel check: the loss and adapter gradients of the first
   local step and of the trained adapters, kernel path against the
   plain-version path, in f32 on the same weights upcast (within 1e-4) and in
   bf16 (a gross bound, GRAD_TOL); the whole bf16 run's round losses against
   a run on the plain versions.
10. Time each kernel at its main-path shape (CUDA events), beside its plain
   version, one PyTorch library call where one computes the same function,
   and the H100 bound (LoRA also at (256, 4096) and (384, 4096), with its
   bytes-only floor, an f32 ``torch.addmm`` beside the bf16 one and the
   device time of each CUDA kernel it launches; flash also at (4, 96, 32,
   128)); the gradients beside autograd through the plain versions and SDPA; and the training step, Fisher batch, merge and round
   end to end. The kernels' line is printed at the end.
11. Profile a short full-width serving run and one full-width local step
   (torch.profiler): device busy share and device time by kernel.
12. The ssm family (mamba2-130m, 24 layers, d_model 768, 24 SSD heads of 64,
   state 128, chunk 256), through the SSD scan kernel:
   a. kernel parity: the SSD kernel against its plain version over the
      harness grid and the full-width shapes (1, 512) and (4, 1024), f32 at
      1e-6 and bf16 at 5e-2, its gradients (kernel forward, backward
      recomputed through the plain version) against autograd, and the LoRA
      and Fisher kernels at d_model 768;
   b. smoke mamba2 in f32, card (kernels) against CPU (plain versions):
      serving tokens equal, two FedNano rounds within 1e-5;
   c. full-width serving, bf16 weights from seed 0: 16 requests from 4
      tenants and base traffic, ragged prompts of 64-512 tokens and one of
      2, prefill_len 512 (two chunks), 16 new tokens, 8 decode slots, 8
      adapter slots, counters reset around the run; prefill logits, kernels
      against plain versions, in bf16 and in f32 on the same weights;
   d. full-width training: FedNano, 2 clients x 2 rounds, 2 local steps and
      2 Fisher batches, batch 4 x 1024 text tokens (four chunks a row),
      kernels on, counters reset around the run, and one agg_chunk=1 round;
      loss and adapter gradients of one step, kernels against plain
      versions, in f32 (1e-4) and bf16;
   e. timings: the SSD kernel at both full-width shapes against its plain
      version and its bound, the LoRA kernel at d_model 768, the local step,
      Fisher batch, merge and round; a profiled local step.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA card, or
without the repository beside this file, it fails before printing a result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and operations/s by type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
SCALE = 2.0
# Full-width prefill logits, kernels vs their plain versions, relative to ‖ref‖∞.
# f32 holds the kernels to their arithmetic through all 32 layers. In bf16 a
# one-ulp difference in a kernel's rounded output grows through 32 layers of
# random weights (3.5e-2 and 3.8e-2 measured on an H100 at 700 W, where 2e-2
# was hoped for; the model's own use_pallas=False path differs by 5e-2 to
# 6e-2), so bf16 gets a gross-error bound.
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 1e-1}
TRAIN_HP = dict(lr=5e-3, local_steps=2, fisher_batches=2)
TRAIN_DATA = dict(n_clients=2, examples_per_client=32, batch_size=4, seq_len=32, seed=0)
# Full-width loss and adapter gradients of one step, kernels vs plain
# versions, relative to ‖ref‖∞: f32 holds the kernels' arithmetic through 32
# layers forward and back (2.8e-6 and 3.2e-6 for the gradients measured on an
# H100 at 700 W). In bf16 the forward's rounding differences (3.5e-2 to
# 3.8e-2 in PR 11's logits) pass through the backward's 32 layers again:
# 2.4e-2 and 3.0e-2 measured for the gradients, 6.4e-4 and 4.7e-3 for the
# losses. The bf16 bounds are about 3x those: they catch a gross fault of
# the bf16 path, while the kernels themselves are held by the f32 bound
# and by phase 6's bf16 check at 2e-2.
GRAD_TOL = {"float32": 1e-4, "bfloat16": 1e-1}
LOSS_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# The whole bf16 run's round losses, kernels vs plain versions: AdamW's first
# step moves every adapter element with |g| >> 1e-8 by about lr·sign(g), so
# bf16 noise in small gradient elements moves whole entries (the final
# adapters differ by 1.1 of ‖ref‖∞), and round 1 starts from other adapters:
# 5.1e-3 measured on the H100. About 4x that, for a gross fault.
RUN_LOSS_TOL_BF16 = 2e-2
MAMBA = "mamba2-130m"
# Full-width serving of each arch: engine settings and the number of requests.
SERVE_KW = {
    "llava-1.5-7b": dict(max_slots=8, prefill_len=128, max_new_tokens=16, adapter_slots=8),
    MAMBA: dict(max_slots=8, prefill_len=512, max_new_tokens=16, adapter_slots=8),
}
# Smoke-size serving and training of each arch, card against CPU. mamba2's
# prompts and rows cross its smoke config's 32-step SSD chunk.
SMOKE_SERVE = {"llava-1.5-7b": (dict(max_slots=3, prefill_len=8, max_new_tokens=6,
                                     adapter_slots=4), 6),
               MAMBA: (dict(max_slots=3, prefill_len=40, max_new_tokens=6, adapter_slots=4),
                       12)}
SMOKE_SEQ = {"llava-1.5-7b": 16, MAMBA: 40}
TRAIN_DATA_BY_ARCH = {"llava-1.5-7b": TRAIN_DATA, MAMBA: dict(TRAIN_DATA, seq_len=1024)}
# The kernels each main path must launch.
SERVING_KERNELS_BY_ARCH = {"llava-1.5-7b": ("lora_residual", "grouped_lora_residual",
                                            "flash_attention"),
                           MAMBA: ("lora_residual", "grouped_lora_residual", "ssd_scan")}
TRAINING_KERNELS_BY_ARCH = {"llava-1.5-7b": ("lora_residual", "flash_attention",
                                             "fisher_merge"),
                            MAMBA: ("lora_residual", "ssd_scan", "fisher_merge")}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernel parity
# ---------------------------------------------------------------------------

def rel_gap(got, want):
    """-> (max |got - want| / max(1, ‖want‖∞), share of elements that differ)."""
    g, w = got.float(), want.float()
    scale = max(1.0, float(w.abs().max())) if w.numel() else 1.0
    diff = (g - w).abs()
    return float(diff.max()) / scale, float((diff > 0).float().mean())


def parity(torch, harness, lora_ops, lora_ref, fa_ops, fa_ref):
    """-> ({kernel: max |err| at its main-path shape in bf16}, {bf16 kernel:
    its gaps to its rounding model and to the exact plain version})."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    main_err = {}
    gaps = {"lora_residual": [0.0, 0.0], "flash_attention": [0.0, 0.0]}  # vs model: err, share
    n_cases = 0
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for t, d, r, _ in (harness.LORA_SHAPES + harness.FULL_LORA_SHAPES
                           + harness.LORA_EDGE_SHAPES):
            x, down, up = randn((t, d), dtype=dtype), randn((d, r), 0.05), randn((r, d), 0.05)
            got = lora_ops.lora_residual(x, down, up, scale=SCALE)
            err = harness.check_close(got, lora_ref.lora_residual(x, down, up, scale=SCALE),
                                      dtype_name, f"lora t{t}d{d}r{r}")
            n_cases += 1
            if dtype_name == "bfloat16":
                model = lora_ref.lora_residual_split_tf32(x, down, up, scale=SCALE)
                harness.check_close(got, model, dtype_name, f"lora t{t}d{d}r{r} vs model",
                                    harness.BF16_MODEL_TOLERANCES)
                harness.check_share(got, model, harness.LORA_MODEL_MAX_SHARE,
                                    f"lora t{t}d{d}r{r} vs model")
                g = rel_gap(got, model)
                gaps["lora_residual"] = [max(a, b) for a, b in zip(gaps["lora_residual"], g)]
            if (t, d, r) == harness.FULL_LORA_SHAPES[0][:3] and dtype_name == "bfloat16":
                main_err["lora_residual"] = err
        for t, d, r, n, _ in harness.GROUPED_LORA_SHAPES + harness.FULL_GROUPED_SHAPES:
            x = randn((t, d), dtype=dtype)
            down, up = randn((n, d, r), 0.05), randn((n, r, d), 0.05)
            idx = torch.randint(-1, n, (t,), generator=gen, device=dev, dtype=torch.int32)
            got = lora_ops.grouped_lora_residual(x, down, up, idx, scale=SCALE)
            want = lora_ref.grouped_lora_residual(x, down, up, idx, scale=SCALE)
            err = harness.check_close(got, want, dtype_name, f"grouped t{t}d{d}n{n}")
            if not torch.equal(got[idx < 0], x[idx < 0]):
                raise AssertionError(f"grouped t{t}d{d}n{n}: identity rows differ from x")
            if dtype_name == "float32":
                for a in range(n):
                    single = lora_ops.lora_residual(x, down[a], up[a], scale=SCALE)
                    if not torch.equal(got[idx == a], single[idx == a]):
                        raise AssertionError(f"grouped t{t}d{d}n{n}: adapter {a} rows are not "
                                             "bit-identical to the single-adapter kernel")
            n_cases += 1
            if (t, d, r, n) == harness.FULL_GROUPED_SHAPES[0][:4] and dtype_name == "bfloat16":
                main_err["grouped_lora_residual"] = err
        for shape in harness.FLASH_SHAPES + harness.FULL_FLASH_SHAPES + harness.FLASH_EDGE_SHAPES:
            label, b, sq, sk, h, hkv, d, causal, window, cap, _, _ = shape
            q = randn((b, sq, h, d), dtype=dtype)
            k, v = randn((b, sk, hkv, d), dtype=dtype), randn((b, sk, hkv, d), dtype=dtype)
            kw = dict(causal=causal, window=window, softcap=cap, return_lse=True)
            got, got_lse = fa_ops.flash_attention(q, k, v, **kw)
            want, want_lse = fa_ref.attention(q, k, v, **kw)
            err = harness.check_close(got, want, dtype_name, f"flash {label}")
            harness.check_close(got_lse, want_lse, dtype_name, f"flash {label} lse")
            n_cases += 1
            if dtype_name == "bfloat16":
                model, model_lse = fa_ref.attention_bf16_model(q, k, v, **kw)
                harness.check_close(got, model, dtype_name, f"flash {label} vs model",
                                    harness.BF16_MODEL_TOLERANCES)
                harness.check_close(got_lse, model_lse, "float32", f"flash {label} lse vs model")
                g = rel_gap(got, model)
                gaps["flash_attention"] = [max(a, b) for a, b in zip(gaps["flash_attention"], g)]
            if label == harness.FULL_FLASH_SHAPES[0][0] and dtype_name == "bfloat16":
                main_err["flash_attention"] = err
    try:
        q = randn((1, 4, 2, 96))
        fa_ops.flash_attention(q, q, q)
    except ValueError:
        pass
    else:
        raise AssertionError("flash_attention accepted head dim 96")
    torch.cuda.synchronize()
    log(f"[parity] {n_cases} kernel-vs-plain cases passed (f32 and bf16, tile edges "
        f"included); main-path bf16 max |err|: {json.dumps(main_err)}")
    bound = harness.BF16_MODEL_TOLERANCES["bfloat16"]
    for name, (err, share) in gaps.items():
        log(f"[parity] {name} bf16 kernel vs its rounding model over the grid, full-width and "
            f"edge shapes: max |err| / max(1, ‖ref‖∞) {err:.3e}, elements that differ "
            f"{share:.3e} (bound rtol {bound['rtol']}, atol {bound['atol_scale']})")
    accuracy_gaps(torch, harness, lora_ops, lora_ref, fa_ops, fa_ref, randn)
    return main_err


def accuracy_gaps(torch, harness, lora_ops, lora_ref, fa_ops, fa_ref, randn):
    """Log what the bf16 kernels' arithmetic costs at the main-path shapes:
    each kernel's bf16 output and the exact plain version's bf16 output,
    both against the exact function in f32 (bf16 inputs upcast); each
    rounding model against the exact plain version (LoRA in f32, flash in
    bf16); and, for LoRA, the share of bf16 outputs that differ from the
    split-TF32 model for the kernel and for the designs it does not use."""
    bf16 = torch.bfloat16
    out = {}
    for t, d, r, _ in harness.FULL_LORA_SHAPES[:1] + harness.MAMBA_LORA_SHAPES[1:]:
        x, down, up = randn((t, d), dtype=bf16), randn((d, r), 0.05), randn((r, d), 0.05)
        exact = lora_ref.lora_residual(x.float(), down, up, scale=SCALE)
        got = lora_ops.lora_residual(x, down, up, scale=SCALE)
        plain = lora_ref.lora_residual(x, down, up, scale=SCALE)
        model = lora_ref.lora_residual_split_tf32(x, down, up, scale=SCALE)
        shares = {"kernel": got, "exact plain": plain,
                  "single-pass TF32": lora_ref.lora_residual_tf32(x, down, up, scale=SCALE),
                  "bf16 adapters": lora_ref.lora_residual(x, down.to(bf16).float(),
                                                          up.to(bf16).float(), scale=SCALE)}
        out[f"lora x ({t}, {d})"] = dict(
            kernel=rel_gap(got, exact), plain=rel_gap(plain, exact),
            kernel_vs_plain=rel_gap(got, plain),
            model=rel_gap(lora_ref.lora_residual_split_tf32(x.float(), down, up, scale=SCALE),
                          exact),
            shares={k: rel_gap(y, model)[1] for k, y in shares.items()})
    for shape in harness.FULL_FLASH_SHAPES[:1] + harness.FULL_FLASH_GRAD_SHAPES:
        label, b, sq, sk, h, hkv, d, causal, window, cap, _, _ = shape
        q, k, v = (randn(s, dtype=bf16) for s in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d)))
        exact = fa_ref.attention(q.float(), k.float(), v.float(), causal=causal)
        got = fa_ops.flash_attention(q, k, v, causal=causal)
        plain = fa_ref.attention(q, k, v, causal=causal)
        out[f"flash {label}"] = dict(
            kernel=rel_gap(got, exact), plain=rel_gap(plain, exact),
            kernel_vs_plain=rel_gap(got, plain),
            model=rel_gap(fa_ref.attention_bf16_model(q, k, v, causal=causal), plain))
    torch.cuda.synchronize()
    for key, g in out.items():
        log(f"[accuracy] {key} bf16, max |err| / max(1, ‖ref‖∞) against the f32 function of "
            f"the same inputs: kernel {g['kernel'][0]:.3e} | exact plain version rounded to "
            f"bf16 {g['plain'][0]:.3e} | kernel vs plain {g['kernel_vs_plain'][0]:.3e}, "
            f"elements that differ {g['kernel_vs_plain'][1]:.3e} | rounding model vs exact "
            f"plain version {g['model'][0]:.3e}")
        if "shares" in g:
            log(f"[accuracy] {key} bf16, share of elements that differ from the split-TF32 "
                f"model (limit {harness.LORA_MODEL_MAX_SHARE}): "
                + ", ".join(f"{k} {v:.3e}" for k, v in g["shares"].items()))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def serving_smoke(torch, get_smoke_config, init_backbone, synth, make_requests, Engine,
                  arch="llava-1.5-7b"):
    """Smoke ``arch`` on the card (kernels, f32) vs on the CPU (plain versions)."""
    from repro_torch.utils import tree_map

    names = ["tenant0", "tenant1"]
    kw, n_req = SMOKE_SERVE[arch]
    runs = {}
    for dev in ("cuda", "cpu"):
        cfg = get_smoke_config(arch).with_(use_pallas=True)
        backbone = init_backbone(cfg, seed=1, device="cpu")
        tenants = synth(1, cfg, names, "cpu")
        if dev == "cuda":
            backbone = tree_map(lambda t: t.to(dev), backbone)
            tenants = tree_map(lambda t: t.to(dev), tenants)
        eng = Engine(cfg, backbone, adapter_loader=tenants.__getitem__,
                     use_pallas_grouped=True, **kw)
        reqs = make_requests(cfg, names, n_req, kw["prefill_len"], kw["max_new_tokens"], 1)
        done = eng.run(reqs)
        runs[dev] = ({rid: c.tokens for rid, c in done.items()},
                     torch.stack([eng.prefill_logits(r).cpu() for r in reqs]))
    tok_gpu, lg_gpu = runs["cuda"]
    tok_cpu, lg_cpu = runs["cpu"]
    err = float((lg_gpu - lg_cpu).abs().max())
    bound = 1e-5 * float(lg_cpu.abs().max())
    if err > bound:
        raise AssertionError(f"smoke prefill logits: card vs CPU max |err| {err:.3e} > {bound:.3e}")
    if tok_gpu != tok_cpu:
        raise AssertionError(f"smoke tokens differ: card {tok_gpu} cpu {tok_cpu}")
    log(f"[smoke] smoke {arch} f32: card (kernels) == CPU (plain) tokens for {n_req} "
        f"requests; prefill logits max |err| {err:.3e} (bound {bound:.3e})")


def serve_requests(arch, cfg, names, make_requests, kw, seed):
    """The main path's 16 requests: ``make_requests``' mix of tenants and base
    traffic; for mamba2 with ragged prompts of 64-512 tokens and one of 2."""
    import numpy as np

    reqs = make_requests(cfg, names, 16, kw["prefill_len"], kw["max_new_tokens"], seed)
    if arch == MAMBA:
        rng = np.random.default_rng(seed + 1)
        top = kw["prefill_len"]
        lengths = [2] + [int(v) for v in np.linspace(min(64, top), top, len(reqs) - 1)]
        for r, n in zip(reqs, lengths):
            r.prompt = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
    return reqs


def serving_full(torch, get_config, init_backbone, synth, make_requests, Engine, counters,
                 arch="llava-1.5-7b"):
    """-> launches per kernel in the main-path run."""
    from repro_torch.utils import tree_leaves, tree_map

    cfg = get_config(arch).with_(use_pallas=True)
    t0 = time.perf_counter()
    backbone = init_backbone(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(backbone))
    log(f"[serve] {arch} backbone: {n_params / 1e9:.3f} B params "
        f"({cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.dtype}) drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    names = [f"tenant{i}" for i in range(4)]
    tenants = synth(0, cfg, names, "cuda")
    kw = dict(SERVE_KW[arch], adapter_loader=tenants.__getitem__)
    reqs = serve_requests(arch, cfg, names, make_requests, kw, 0)
    log(f"[serve] {arch}: prompt lengths {[len(r.prompt) for r in reqs]}, prefill_len "
        f"{kw['prefill_len']}, tenants {[r.tenant for r in reqs]}")

    # warm-up: cuBLAS handles, allocator pools, first kernel launches
    Engine(cfg, backbone, use_pallas_grouped=True, **kw).run(
        [dataclasses.replace(r, max_new_tokens=2) for r in reqs[:2]])
    torch.cuda.synchronize()

    eng = Engine(cfg, backbone, use_pallas_grouped=True, **kw)
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()

    if sorted(done) != [r.rid for r in reqs]:
        raise AssertionError(f"completed {sorted(done)} of {len(reqs)} requests")
    for r in reqs:
        toks = done[r.rid].tokens
        if len(toks) != r.max_new_tokens or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"request {r.rid}: tokens {toks}")
    if not all(launches[n] for n in SERVING_KERNELS_BY_ARCH[arch]):
        raise AssertionError(f"a kernel of the {arch} serving path never launched: {launches}")
    st = eng.stats
    n_tok = sum(len(c.tokens) for c in done.values())
    log(f"[serve] {arch}: {len(reqs)} requests, {n_tok} tokens in {wall:.3f} s: "
        f"{n_tok / wall:.1f} tokens/s | prefill {1e3 * st['prefill_s'] / st['prefills']:.2f} "
        f"ms/request | decode step {1e3 * st['decode_s'] / st['decode_steps']:.2f} ms "
        f"({st['decode_steps']} steps, occupancy {eng.mean_occupancy():.2f}/8) | "
        f"peak memory {peak / 2**30:.2f} GiB | launches {json.dumps(launches)}")

    kernel16 = [eng.prefill_logits(r) for r in reqs]
    done_plain, plain16 = run_plain_versions(cfg, backbone, Engine, kw, reqs, counters)
    worst = hold(torch, cfg.dtype, reqs, kernel16, plain16)
    log(f"[serve] {arch} bf16, kernels vs their plain versions: prefill logits max |err| / "
        f"‖ref‖∞ = {worst:.3e} (limit {LOGIT_TOL['bfloat16']}); "
        f"{agreement(reqs, done, done_plain)}")

    # for information: the model's plain path (use_pallas off: bf16 adapter
    # products, probabilities cast to bf16 before the product with V)
    jnp_path = Engine(cfg.with_(use_pallas=False), backbone, use_pallas_grouped=False, **kw)
    done_jnp = jnp_path.run(reqs)
    jnp16 = [jnp_path.prefill_logits(r) for r in reqs]
    log(f"[serve] {arch} bf16, kernels vs the use_pallas=False path: prefill logits max |err| / "
        f"‖ref‖∞ = {rel_err(kernel16, jnp16):.3e}; {agreement(reqs, done, done_jnp)}")

    # f32 on the same weights, upcast exactly: the kernels against their plain
    # versions without bf16 rounding, and the reference for the bf16 runs
    del eng, jnp_path
    cfg32 = cfg.with_(dtype="float32")
    backbone32 = tree_map(lambda t: t.float(), backbone)
    eng32 = Engine(cfg32, backbone32, use_pallas_grouped=True, **kw)
    done32 = eng32.run(reqs)
    kernel32 = [eng32.prefill_logits(r) for r in reqs]
    done32_plain, plain32 = run_plain_versions(cfg32, backbone32, Engine, kw, reqs, counters)
    worst = hold(torch, cfg32.dtype, reqs, kernel32, plain32)
    log(f"[serve] {arch} f32, kernels vs their plain versions: prefill logits max |err| / "
        f"‖ref‖∞ = {worst:.3e} (limit {LOGIT_TOL['float32']}); "
        f"{agreement(reqs, done32, done32_plain)}")
    log(f"[serve] {arch} bf16 runs vs the f32 plain run, prefill logits max |err| / ‖ref‖∞: "
        f"kernels {rel_err(kernel16, plain32):.3e}, plain versions "
        f"{rel_err(plain16, plain32):.3e}, use_pallas=False {rel_err(jnp16, plain32):.3e}; "
        f"kernels' tokens: {agreement(reqs, done, done32_plain)}")
    return launches


def run_plain_versions(cfg, backbone, Engine, kw, reqs, counters):
    """Serve ``reqs`` with each kernel replaced by its plain version.
    -> (completions, prefill logits per request)."""
    with plain_versions(counters):
        plain = Engine(cfg, backbone, use_pallas_grouped=True, **kw)
        done = plain.run(reqs)
        return done, [plain.prefill_logits(r) for r in reqs]


def rel_err(got, want) -> float:
    """Largest max |got - want| / ‖want‖∞ over paired logit vectors."""
    return max(float((g - w).abs().max()) / float(w.abs().max()) for g, w in zip(got, want))


def hold(torch, dtype, reqs, got, want) -> float:
    """Raise unless every request's logits are finite and within LOGIT_TOL[dtype]."""
    for r, g, w in zip(reqs, got, want):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"request {r.rid}: non-finite prefill logits")
        if (e := rel_err([g], [w])) > LOGIT_TOL[dtype]:
            raise AssertionError(f"{dtype} request {r.rid}: prefill logits differ from the "
                                 f"plain run by {e:.3e} of their ∞-norm (> {LOGIT_TOL[dtype]})")
    return rel_err(got, want)


def agreement(reqs, a, b) -> str:
    first = sum(a[r.rid].tokens[0] == b[r.rid].tokens[0] for r in reqs)
    same = total = 0
    for r in reqs:
        x, y = a[r.rid].tokens[1:], b[r.rid].tokens[1:]
        same += sum(i == j for i, j in zip(x, y))
        total += len(x)
    return (f"first tokens equal {first}/{len(reqs)}, decode tokens equal {same}/{total} "
            f"({same / max(total, 1):.3f})")


@contextlib.contextmanager
def plain_versions(counters):
    """Swap each kernel wrapper for its plain version inside its ops module
    (the model code looks the wrapper up there at every call)."""
    from repro_torch.kernels.fisher_merge import ops as fm_ops, ref as fm_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
    from repro_torch.kernels.lora import ops as lora_ops, ref as lora_ref
    from repro_torch.kernels.ssd_scan import ops as ssd_ops, ref as ssd_ref

    # (module, wrapper attribute, plain version, counter name)
    swaps = [(lora_ops, "lora_residual", lora_ref.lora_residual, "lora_residual"),
             (lora_ops, "grouped_lora_residual", lora_ref.grouped_lora_residual,
              "grouped_lora_residual"),
             (fa_ops, "flash_attention", fa_ref.attention, "flash_attention"),
             (fm_ops, "fisher_merge", fm_ref.fisher_merge, "fisher_merge"),
             (fm_ops, "fisher_fold", fm_ref.fisher_fold, "fisher_fold"),
             (ssd_ops, "ssd", ssd_ref.ssd_chunked, "ssd_scan")]
    try:
        for mod, attr, plain, _ in swaps:
            setattr(mod, attr, plain)
        yield
    finally:
        for mod, attr, _, name in swaps:
            setattr(mod, attr, counters[name])


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def sq_loss_grads(fn, *tensors):
    """Gradients of sum(fn(*tensors)²), in f32, by torch.autograd."""
    leaves = [t.detach().clone().requires_grad_(True) for t in tensors]
    (fn(*leaves).float() ** 2).sum().backward()
    return [t.grad for t in leaves]


def training_parity(torch, harness, lora_ops, lora_ref, fa_ops, fa_ref, fm_ops, fm_ref):
    """-> {kernel: max |err| at its main-path shape in f32}."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)

    def randn(shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    main_err, n_cases = {}, 0
    full_fisher = harness.FULL_FISHER_SHAPES[0][:2]
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for k, n, _ in harness.FISHER_SHAPES + harness.FISHER_EXTRA_SHAPES + \
                harness.FULL_FISHER_SHAPES:
            theta = randn((k, n), dtype=dtype)
            fisher = (torch.rand((k, n), generator=gen, device=dev) + 0.01).to(dtype)
            w = torch.rand((k,), generator=gen, device=dev) + 0.1
            err_m = harness.check_close(fm_ops.fisher_merge(theta, fisher, w),
                                        fm_ref.fisher_merge(theta, fisher, w), dtype_name,
                                        f"fisher_merge k{k}n{n}")
            num, den = torch.zeros(n, device=dev), torch.zeros(n, device=dev)
            pnum, pden = num.clone(), den.clone()
            for i in range(k):
                fm_ops.fisher_fold(num, den, theta[i], fisher[i], float(w[i]))
                fm_ref.fisher_fold(pnum, pden, theta[i], fisher[i], float(w[i]))
            err_f = max(harness.check_close(num, pnum, "float32", f"fisher_fold num k{k}n{n}"),
                        harness.check_close(den, pden, "float32", f"fisher_fold den k{k}n{n}"))
            n_cases += 2
            if (k, n) == full_fisher and dtype_name == "float32":
                main_err["fisher_merge"], main_err["fisher_fold"] = err_m, err_f
        for t, d, r, _ in harness.LORA_GRAD_SHAPES + harness.FULL_LORA_GRAD_SHAPES:
            x, down, up = randn((t, d), dtype=dtype), randn((d, r), 0.05), randn((r, d), 0.05)
            got = sq_loss_grads(lambda a, b, c: lora_ops.lora_residual(a, b, c, scale=SCALE),
                                x, down, up)
            want = sq_loss_grads(lambda a, b, c: lora_ref.lora_residual(a, b, c, scale=SCALE),
                                 x, down, up)
            for name, g, wt in zip(("dx", "dA", "dB"), got, want):
                err = harness.check_close(g, wt, dtype_name, f"lora grad {name} t{t}d{d}r{r}")
                if (t, d, r, _) in harness.FULL_LORA_GRAD_SHAPES:
                    key = f"lora_residual {name} {dtype_name}"
                    main_err[key] = max(main_err.get(key, 0.0), err)
            n_cases += 1
        for shape in harness.FLASH_GRAD_SHAPES + harness.FULL_FLASH_GRAD_SHAPES:
            label, b, sq, sk, h, hkv, d, causal, window, cap, _, _ = shape
            q = randn((b, sq, h, d), dtype=dtype)
            k_, v = randn((b, sk, hkv, d), dtype=dtype), randn((b, sk, hkv, d), dtype=dtype)
            kw = dict(causal=causal, window=window, softcap=cap)
            got = sq_loss_grads(lambda *a: fa_ops.flash_attention(*a, **kw), q, k_, v)
            want = sq_loss_grads(lambda *a: fa_ref.attention(*a, **kw), q, k_, v)
            full = label == harness.FULL_FLASH_GRAD_SHAPES[0][0]
            tol = harness.FULL_FLASH_GRAD_TOLERANCES if full else harness.FLASH_GRAD_TOLERANCES
            for name, g, wt in zip(("dq", "dk", "dv"), got, want):
                err = harness.check_close(g, wt, dtype_name, f"flash grad {name} {label}", tol)
                if full:
                    main_err[f"flash_attention {name} {dtype_name}"] = err
            n_cases += 1
    torch.cuda.synchronize()
    log(f"[train-parity] {n_cases} kernel-vs-plain cases passed (fisher_merge, fisher_fold, "
        f"LoRA and flash gradients; f32 and bf16); full-width max |err|: {json.dumps(main_err)}")
    return main_err


def fresh_server(server):
    """The same backbone and global adapters with an empty comm log (the
    engine appends to the one it is given)."""
    from repro_torch.core.comm import CommLog

    return dataclasses.replace(server, comm=CommLog(), round_idx=0)


def tree_rel_err(got, want) -> float:
    """Largest max |got - want| / ‖want‖∞ over the leaves of two adapter trees
    (a leaf that is zero in both, as the down-projection's gradient at the
    first step, counts 0)."""
    from repro_torch.utils import tree_leaves

    return max(float((g.float() - w.float()).abs().max())
               / max(float(w.float().abs().max()), 1e-30)
               for g, w in zip(tree_leaves(got), tree_leaves(want)))


def training_smoke(torch, tr, arch="llava-1.5-7b"):
    """Two FedNano rounds of smoke ``arch`` in f32: card (kernels) vs CPU (plain)."""
    from repro_torch.utils import tree_map

    cfg = tr["get_smoke_config"](arch).with_(use_pallas=True)
    hp = tr["HyperParams"](**TRAIN_HP)
    data_kw = dict(n_clients=2, examples_per_client=16, batch_size=4, seq_len=SMOKE_SEQ[arch],
                   seed=0)
    server_cpu = tr["init_server"](cfg, seed=3, device="cpu")
    runs, step = {}, {}
    for dev in ("cuda", "cpu"):
        server = server_cpu
        if dev == "cuda":
            server = dataclasses.replace(server_cpu, backbone=tree_map(lambda t: t.to(dev),
                                                                   server_cpu.backbone),
                                         global_adapters=tree_map(lambda t: t.to(dev),
                                                              server_cpu.global_adapters))
        train, evald, _ = tr["make_federated_data"](cfg, device=dev, **data_kw)
        batch = train[0][0]
        step[dev] = tr["client"].value_and_grad(
            lambda a: tr["fednano_loss"](cfg, server.backbone, a, batch), server.global_adapters)
        runs[dev] = tr["run_federated"](0, cfg, train, evald, rounds=2, hp=hp, use_pallas=True,
                                        server=fresh_server(server))
    gpu, cpu = runs["cuda"], runs["cpu"]
    gl = [m["mean_loss"] for m in gpu.round_metrics]
    cl = [m["mean_loss"] for m in cpu.round_metrics]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
    step_loss = abs(float(step["cuda"][0]) - float(step["cpu"][0])) / abs(float(step["cpu"][0]))
    step_grad = tree_rel_err(tree_map(lambda t: t.cpu(), step["cuda"][2]), step["cpu"][2])
    adp_err = tree_rel_err(tree_map(lambda t: t.cpu(), gpu.server.global_adapters),
                           cpu.server.global_adapters)
    if loss_err > 1e-5 or step_loss > 1e-5 or step_grad > 1e-5:
        raise AssertionError(f"smoke training, card vs CPU: round losses {gl} vs {cl} "
                             f"({loss_err:.3e}), first step loss {step_loss:.3e}, "
                             f"grads {step_grad:.3e} (bound 1e-5)")
    if adp_err > 1e-5 or gpu.comm_totals != cpu.comm_totals:
        raise AssertionError(f"smoke training: global adapters {adp_err:.3e} (bound 1e-5); "
                             f"comm {gpu.comm_totals} vs {cpu.comm_totals}")
    log(f"[train-smoke] smoke {arch} f32, 2 rounds: card (kernels) vs CPU (plain): round "
        f"losses {gl} vs {cl}, max rel err {loss_err:.3e}; first step loss {step_loss:.3e}, "
        f"grads {step_grad:.3e} (bound 1e-5); global adapters after 2 rounds {adp_err:.3e} "
        f"(bound 1e-5); comm totals equal")


def training_full(torch, tr, counters, arch="llava-1.5-7b"):
    """A training main path at full width. -> (state for later phases,
    launches per kernel on its runs)."""
    from repro_torch.utils import tree_leaves

    cfg = tr["get_config"](arch).with_(use_pallas=True)
    hp = tr["HyperParams"](**TRAIN_HP)
    t0 = time.perf_counter()
    server = tr["init_server"](cfg, seed=0, device="cuda")
    train, evald, _ = tr["make_federated_data"](cfg, device="cuda", **TRAIN_DATA_BY_ARCH[arch])
    torch.cuda.synchronize()
    b0 = train[0][0]
    n_patches = b0.patches.shape[1] if b0.patches is not None else 0
    tokens_per_step = b0.tokens.shape[0] * (b0.tokens.shape[1] + n_patches)
    log(f"[train] {arch} backbone {cfg.dtype}, rank-{cfg.adapter.rank} "
        f"{cfg.adapter.dtype} adapters {list(cfg.adapter.modalities)}, data "
        f"{[len(train[c]) for c in sorted(train)]} train / {[len(evald[c]) for c in sorted(evald)]}"
        f" eval batches per client, batch {tuple(b0.tokens.shape)} tokens + {n_patches} "
        f"patches a row ({tokens_per_step} positions a step); drawn in "
        f"{time.perf_counter() - t0:.1f} s")

    # warm-up: cuBLAS handles, allocator pools, first launches
    tr["client"].train_step(cfg, tr["get_strategy"]("fednano"), hp, server.backbone,
                            server.global_adapters,
                            tr["adamw_init"](server.global_adapters), b0, server.global_adapters)
    torch.cuda.synchronize()

    def main_path_run(**kw):
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        res = tr["run_federated"](0, cfg, train, evald, strategy="fednano", hp=hp,
                                  use_pallas=True, server=fresh_server(server), **kw)
        torch.cuda.synchronize()
        return (res, time.perf_counter() - t0, {n: fn.launches for n, fn in counters.items()},
                torch.cuda.max_memory_allocated())

    res, wall, launches, peak = main_path_run(rounds=2)
    losses = [m["mean_loss"] for m in res.round_metrics]
    leaf_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(server.global_adapters))
    want_bytes = 2 * 2 * leaf_bytes
    if (len(losses) != 2 or not all(math.isfinite(x) for x in losses)
            or [m["participants"] for m in res.round_metrics] != [2, 2]):
        raise AssertionError(f"full-width training: round metrics {res.round_metrics}")
    if not all(bool(torch.isfinite(t).all()) for t in tree_leaves(res.server.global_adapters)):
        raise AssertionError("full-width training: non-finite global adapters")
    c = res.comm_totals
    if not c["param_up"] == c["fisher_up"] == c["param_down"] == want_bytes:
        raise AssertionError(f"full-width training: comm totals {c}, want {want_bytes} each")
    if not all(0.0 <= a <= 1.0 for a in res.client_accuracy.values()):
        raise AssertionError(f"client accuracy {res.client_accuracy}")
    for name in TRAINING_KERNELS_BY_ARCH[arch]:
        if launches[name] <= 0:
            raise AssertionError(f"the {name} kernel never launched on the {arch} training "
                                 f"path: {launches}")
    log(f"[train] {arch} fednano, 2 clients x 2 rounds x ({hp.local_steps} steps + "
        f"{hp.fisher_batches} Fisher batches), merge by fisher_merge: round losses {losses}, "
        f"client accuracy {res.client_accuracy}, comm {c}; wall {wall:.3f} s with final eval; "
        f"peak memory {peak / 2**30:.2f} GiB | launches {json.dumps(launches)}")

    res_f, wall_f, launches_f, _ = main_path_run(rounds=1, agg_chunk=1, final_eval=False)
    if launches_f["fisher_fold"] <= 0:
        raise AssertionError(f"the fisher_fold kernel never launched: {launches_f}")
    uploads = [(cl.adapters, cl.fisher, cl.n_examples) for cl in res_f.clients]
    batch = tr["get_strategy"]("fednano").aggregate([u[0] for u in uploads],
                                                    [u[1] for u in uploads],
                                                    [u[2] for u in uploads], use_pallas=True)
    fold_err = tree_rel_err(res_f.server.global_adapters, batch)
    loss0 = res_f.round_metrics[0]["mean_loss"]
    if fold_err > 1e-6 or abs(loss0 - losses[0]) > 1e-5 * abs(losses[0]):
        raise AssertionError(f"round 0 by fisher_fold vs fisher_merge: adapters {fold_err:.3e} "
                             f"(bound 1e-6); loss {loss0} vs {losses[0]}")
    log(f"[train] {arch} agg_chunk=1, round 0 folded one client at a time by fisher_fold: loss "
        f"{loss0} (merge run {losses[0]}); streamed merge vs fisher_merge of the same uploads "
        f"{fold_err:.3e} of ‖ref‖∞ (bound 1e-6); wall {wall_f:.3f} s | launches "
        f"{json.dumps(launches_f)}")
    path = "train" if arch == "llava-1.5-7b" else f"train_{arch.split('-')[0]}"
    launches_by_path = {path: {n: launches[n] + launches_f[n] for n in launches}}
    state = dict(cfg=cfg, hp=hp, server=server, train=train, evald=evald, res=res,
                 tokens_per_step=tokens_per_step, peak=peak)
    return state, launches_by_path


def training_check(torch, tr, st, counters):
    """Full-width loss and adapter gradients, kernel path vs plain-version path."""
    from repro_torch.utils import tree_map

    cfg, server, batch = st["cfg"], st["server"], st["train"][0][0]
    points = (("first step", server.global_adapters),
              ("trained", st["res"].server.global_adapters))

    def loss_and_grads(c, backbone, adapters):
        loss, _, grads = tr["client"].value_and_grad(
            lambda a: tr["fednano_loss"](c, backbone, a, batch), adapters)
        return float(loss), grads

    out = {}
    for dtype in ("bfloat16", "float32"):
        c = cfg.with_(dtype=dtype)
        backbone = server.backbone if dtype == "bfloat16" else tree_map(lambda t: t.float(),
                                                                    server.backbone)
        for label, adp in points:
            lk, gk = loss_and_grads(c, backbone, adp)
            with plain_versions(counters):
                lp, gp = loss_and_grads(c, backbone, adp)
            le, ge = abs(lk - lp) / abs(lp), tree_rel_err(gk, gp)
            out[(dtype, label)] = (lk, lp, le, ge)
            if not math.isfinite(lk) or le > LOSS_TOL[dtype] or ge > GRAD_TOL[dtype]:
                raise AssertionError(f"{dtype} {label}: loss {lk} vs {lp} ({le:.3e}, bound "
                                     f"{LOSS_TOL[dtype]}), adapter grads {ge:.3e} of ‖ref‖∞ "
                                     f"(bound {GRAD_TOL[dtype]})")
        del backbone
    torch.cuda.empty_cache()
    for (dtype, label), (lk, lp, le, ge) in out.items():
        log(f"[train-check] {cfg.name} {dtype} {label}: loss kernels {lk:.7f} plain {lp:.7f} (rel "
            f"{le:.3e}, bound {LOSS_TOL[dtype]}); adapter grads max |err| / ‖ref‖∞ {ge:.3e} "
            f"(bound {GRAD_TOL[dtype]})")

    with plain_versions(counters):
        plain = tr["run_federated"](0, cfg, st["train"], st["evald"], strategy="fednano",
                                    hp=st["hp"], rounds=2, use_pallas=True,
                                    server=fresh_server(server))
    kl = [m["mean_loss"] for m in st["res"].round_metrics]
    pl = [m["mean_loss"] for m in plain.round_metrics]
    le = max(abs(a - b) / abs(b) for a, b in zip(kl, pl))
    ae = tree_rel_err(st["res"].server.global_adapters, plain.server.global_adapters)
    if le > RUN_LOSS_TOL_BF16:
        raise AssertionError(f"bf16 run, kernels vs plain versions: round losses {kl} vs {pl}")
    log(f"[train-check] {cfg.name} bf16 whole run, kernels vs plain versions: round losses "
        f"{kl} vs {pl} "
        f"(max rel {le:.3e}, bound {RUN_LOSS_TOL_BF16}); final global adapters "
        f"{ae:.3e} of ‖ref‖∞ (reported)")


def time_host(torch, fn, reps: int = 5) -> float:
    """Host ms per call of ``fn`` ending in a device synchronize, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def time_events(torch, fn, iters: int = 20) -> float:
    """Device ms per call from CUDA events around ``iters`` calls issued from
    Python (for work a CUDA graph cannot capture, such as autograd's backward)."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def training_timings(torch, F, tr, st, fm_ops, fm_ref, lora_ops, lora_ref, fa_ops, fa_ref):
    """The new kernels at the slice's shapes and the training loop end to end."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    cfg = st["cfg"]
    out = {}

    # the server's merge of 2 clients' (4096, 64) f32 leaves, one leaf a call
    K, N = 2, cfg.d_model * cfg.adapter.rank
    theta = torch.randn((K, N), generator=gen, device=dev)
    fisher = torch.rand((K, N), generator=gen, device=dev) + 0.01
    w = torch.tensor([0.5, 0.5], device=dev)
    merged = fm_ops.fisher_merge(theta, fisher, w)
    num, den = torch.zeros(N, device=dev), torch.zeros(N, device=dev)
    for name, kernel, plain, n_bytes, n_ops in (
            ("fisher_merge", lambda: fm_ops.fisher_merge(theta, fisher, w),
             lambda: fm_ref.fisher_merge(theta, fisher, w), nbytes(theta, fisher, w, merged),
             (4 * K + 2) * N),
            ("fisher_fold", lambda: fm_ops.fisher_fold(num, den, theta[0], fisher[0], 0.5),
             lambda: fm_ref.fisher_fold(num, den, theta[0], fisher[0], 0.5),
             nbytes(num, den, theta[0], fisher[0], num, den), 4 * N)):
        (k_ms, k_is), (p_ms, p_is) = time_ms(torch, kernel), time_ms(torch, plain)
        b_ms, b_by = bound(n_bytes, n_ops, "f32")
        out[name] = dict(ms=k_ms, plain_ms=p_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by)
        log(f"[time] {name} at K={K if name == 'fisher_merge' else 1}, N={N} f32, device ms "
            f"per call (issued from Python): kernel {k_ms:.5f} ({k_is:.5f}) | plain {p_ms:.5f} "
            f"({p_is:.5f}) | library None | bound {b_ms:.5f} ({b_by})")

    # gradients at the training shapes, forward + backward, bf16 activations
    bf16 = torch.bfloat16
    T, D, r = st["tokens_per_step"], cfg.d_model, cfg.adapter.rank
    x = torch.randn((T, D), generator=gen, device=dev).to(bf16)
    A = (torch.randn((D, r), generator=gen, device=dev) * 0.05).requires_grad_(True)
    Bm = (torch.randn((r, D), generator=gen, device=dev) * 0.05).requires_grad_(True)

    def lora_step(fn):
        return lambda: torch.autograd.grad(fn(x, A, Bm, scale=SCALE).float().square().sum(),
                                           (A, Bm))

    # inputs x, A, B and the output gradient; outputs y, dA, dB
    b_ms, b_by = bound(3 * nbytes(x) + 2 * nbytes(A, Bm), 12 * T * D * r, "f32")
    k_ms, p_ms = time_events(torch, lora_step(lora_ops.lora_residual)), \
        time_events(torch, lora_step(lora_ref.lora_residual))
    log(f"[time] lora_residual forward + dA, dB (x frozen) at x ({T}, {D}) bf16, r {r}: "
        f"device ms per step (issued): Function {k_ms:.5f} | plain autograd {p_ms:.5f} | "
        f"bound {b_ms:.5f} ({b_by})")
    Bsz, S, H, hd = 4, T // 4, cfg.n_heads, cfg.resolved_head_dim
    q, k, v = ((torch.randn((Bsz, S, H, hd), generator=gen, device=dev)).to(bf16)
               .requires_grad_(True) for _ in range(3))
    qt, kt, vt = (t.detach().transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))

    def attn_step(fn, *args):
        return lambda: torch.autograd.grad(fn(*args).float().square().sum(), args)

    pairs = S * (S + 1) // 2 * H * Bsz
    # inputs q, k, v and the output gradient; outputs o, dq, dk, dv. Forward
    # 4·hd a pair, backward 10·hd (s again, dp, dv, dq, dk)
    b_ms, b_by = bound(2 * nbytes(q, k, v) + 2 * nbytes(q), 14 * hd * pairs, "bf16")
    k_ms = time_events(torch, attn_step(lambda *a: fa_ops.flash_attention(*a, causal=True),
                                        q, k, v))
    p_ms = time_events(torch, attn_step(lambda *a: fa_ref.attention(*a, causal=True), q, k, v))
    l_ms = time_events(torch, attn_step(
        lambda *a: F.scaled_dot_product_attention(*a, is_causal=True), qt, kt, vt))
    log(f"[time] flash_attention forward + backward at q/k/v ({Bsz}, {S}, {H}, {hd}) bf16 "
        f"causal: device ms per step (issued): Function {k_ms:.5f} | plain autograd "
        f"{p_ms:.5f} | SDPA forward + backward {l_ms:.5f} | bound {b_ms:.5f} ({b_by})")

    loop_timings(torch, tr, st)
    return out


def loop_timings(torch, tr, st):
    """The training loop end to end at full width: local step, Fisher batch,
    server merge, round."""
    from repro_torch.utils import tree_leaves

    cfg, hp, server, train = st["cfg"], st["hp"], st["server"], st["train"]
    strat = tr["get_strategy"]("fednano")
    adp = st["res"].server.global_adapters
    opt = tr["adamw_init"](adp)
    step_ms = time_host(torch, lambda: float(tr["client"].train_step(
        cfg, strat, hp, server.backbone, adp, opt, train[0][0], adp)[2]))
    fisher_ms = time_host(torch, lambda: tr["fisher_pass"](
        lambda a, b: tr["client"].fisher_grad(cfg, server.backbone, a, b), adp, train[0][:1]))
    ups = [(cl.adapters, cl.fisher, cl.n_examples) for cl in st["res"].clients]
    merge_ms = time_host(torch, lambda: strat.aggregate(
        [u[0] for u in ups], [u[1] for u in ups], [u[2] for u in ups], use_pallas=True), reps=20)
    t0 = time.perf_counter()
    tr["run_federated"](0, cfg, train, st["evald"], strategy="fednano", hp=hp, rounds=1,
                        use_pallas=True, server=fresh_server(server), final_eval=False)
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    log(f"[train-time] {cfg.name} local step (forward, backward, AdamW, float(loss)) "
        f"{step_ms:.2f} ms: {st['tokens_per_step'] / step_ms * 1e3:.1f} trained tokens/s | "
        f"Fisher-pass batch {fisher_ms:.2f} ms | server merge ({len(tree_leaves(adp))} leaves, "
        f"fisher_merge) {merge_ms:.3f} ms | round wall (2 clients, no eval) {round_s:.3f} s | "
        f"peak memory of the main run {st['peak'] / 2**30:.2f} GiB")


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_ms(torch, fn, iters: int = 50):
    """-> (device ms per call, issued ms per call), both from CUDA events.

    Device: the calls captured once in a CUDA graph and replayed, so host
    launch overhead drops out. Issued: the calls launched from Python one
    after another, as the engine launches them; it includes that overhead
    whenever the host is slower than the device.
    """
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    issued = start.elapsed_time(end) / iters
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, issued


def bound(n_bytes: float, n_ops: float, op_type: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS[op_type]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def kernel_breakdown(torch, fn, what, calls: int = 20):
    """Log the mean device time of each CUDA kernel ``fn`` launches, from
    torch.profiler over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.end - e.time_range.start, n + 1)
    parts = [f"{name.replace('(anonymous namespace)::', '').split('(')[0][-40:]} "
             f"{t / n:.3f} us ({n} launches)" for name, (t, n) in by_name.items()]
    log(f"[time] {what} device kernels per call (torch.profiler, {calls} calls): "
        + ("; ".join(parts) or "none recorded"))


def lora_timing(torch, lora_ops, lora_ref, x, A, B, what=""):
    """The LoRA kernel at x (T, D) bf16 beside its plain version, two
    torch.addmm yardsticks (adapters cast to bf16, as a bf16 model would
    run them; and the f32 form on x upcast, the kernel's own precision), its
    bound and its bytes-only floor. The bound counts the split-TF32 work the
    f32-accurate products need on the tensor cores: x·A in two TF32
    products and h·B in three, 10·T·D·r operations at the TF32 rate.
    -> a kernel-table row."""
    T, D = x.shape
    r = A.shape[1]
    y = lora_ops.lora_residual(x, A, B, scale=SCALE)
    A16, B16, xf = A.to(torch.bfloat16), B.to(torch.bfloat16), x.float()
    (k_ms, k_is), (p_ms, p_is) = (time_ms(torch, lambda: lora_ops.lora_residual(x, A, B, scale=SCALE)),
                                  time_ms(torch, lambda: lora_ref.lora_residual(x, A, B, scale=SCALE)))
    l_ms, l_is = time_ms(torch, lambda: torch.addmm(x, x @ A16, B16, alpha=SCALE))
    l32_ms, _ = time_ms(torch, lambda: torch.addmm(xf, xf @ A, B, alpha=SCALE))
    n_bytes = nbytes(x, A, B, y)
    b_ms, b_by = bound(n_bytes, 10 * T * D * r, "tf32")
    floor_ms = 1e3 * n_bytes / HBM_BYTES_PER_S
    log(f"[time] lora_residual at x ({T}, {D}) bf16, r {r}{what}, device ms per call (issued "
        f"from Python): kernel {k_ms:.5f} ({k_is:.5f}) | plain {p_ms:.5f} ({p_is:.5f}) | "
        f"library torch.addmm with bf16 adapters {l_ms:.5f} ({l_is:.5f}), f32 "
        f"torch.addmm(xf, xf @ A, B) {l32_ms:.5f} | bound {b_ms:.5f} ({b_by}; 10·T·D·r "
        f"operations at the TF32 rate) | bytes-only floor {floor_ms:.5f}")
    return dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=b_by,
                library_f32_ms=l32_ms, bytes_floor_ms=floor_ms, shape=[T, D, r])


def flash_timing(torch, F, fa_ops, fa_ref, q, k, v, what=""):
    """The flash kernel (causal) beside its plain version, SDPA and its
    bound. -> a kernel-table row."""
    B, S, H, hd = q.shape
    o, lse = fa_ops.flash_attention(q, k, v, causal=True, return_lse=True)
    pairs = S * (S + 1) // 2 * H * B
    b_ms, b_by = bound(nbytes(q, k, v, o, lse), 4 * hd * pairs, "bf16")
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    (k_ms, k_is), (p_ms, p_is) = (time_ms(torch, lambda: fa_ops.flash_attention(q, k, v, causal=True)),
                                  time_ms(torch, lambda: fa_ref.attention(q, k, v, causal=True)))
    l_ms, l_is = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    log(f"[time] flash_attention at q/k/v ({B}, {S}, {H}, {hd}) bf16 causal{what}, device ms per "
        f"call (issued from Python): kernel {k_ms:.5f} ({k_is:.5f}) | plain {p_ms:.5f} "
        f"({p_is:.5f}) | library SDPA {l_ms:.5f} ({l_is:.5f}) | bound {b_ms:.5f} ({b_by})")
    return dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=b_by,
                shape=[B, S, H, hd])


def timings(torch, F, lora_ops, lora_ref, fa_ops, fa_ref):
    """Each kernel at its main-path shape: llava-1.5-7b, prefill_len 128,
    64 patches, 8 decode slots, 8 adapter slots, rank 64, bf16 activations;
    LoRA also at training's (256, 4096) image rows and (384, 4096), flash
    also at training's (4, 96, 32, 128)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    bf16 = torch.bfloat16
    out = {}
    T, D, r, N = 128, 4096, 64, 8

    # text NanoAdapter at prefill: x (T, D) bf16, adapters f32; then training's rows
    lora = {}
    for t in (T, 256, 384):
        lora[t] = lora_timing(torch, lora_ops, lora_ref, randn((t, D), dtype=bf16),
                              randn((D, r), 0.05), randn((r, D), 0.05))
    out["lora_residual"] = dict(lora[T], shapes={f"x ({t}, {D})": row for t, row in lora.items()})
    x, A, B = randn((T, D), dtype=bf16), randn((D, r), 0.05), randn((r, D), 0.05)
    kernel_breakdown(torch, lambda: lora_ops.lora_residual(x, A, B, scale=SCALE),
                     f"lora_residual at x ({T}, {D})")

    # text bank at decode: 8 slots, 4 tenants + 1 base row + adapters reused
    xs = randn((N, D), dtype=bf16)
    downs, ups = randn((N, D, r), 0.05), randn((N, r, D), 0.05)
    idx = torch.tensor([0, 1, 2, 3, 0, 1, 2, -1], dtype=torch.int32, device=dev)
    used = sorted({int(i) for i in idx.tolist() if 0 <= i < N})
    live = int((idx >= 0).sum())
    ys = lora_ops.grouped_lora_residual(xs, downs, ups, idx, scale=SCALE)
    b_ms, b_by = bound(nbytes(xs, ys, idx) + len(used) * nbytes(downs[0], ups[0]),
                       4 * live * D * r + 2 * live * D, "f32")
    (k_ms, k_is), (p_ms, p_is) = (
        time_ms(torch, lambda: lora_ops.grouped_lora_residual(xs, downs, ups, idx, scale=SCALE)),
        time_ms(torch, lambda: lora_ref.grouped_lora_residual(xs, downs, ups, idx, scale=SCALE)))
    out["grouped_lora_residual"] = dict(ms=k_ms, plain_ms=p_ms, library_ms=None, bound_ms=b_ms,
                                        bound_by=b_by)
    log(f"[time] grouped_lora_residual at x ({N}, {D}) bf16, idx {idx.tolist()}, bank ({N}, "
        f"{D}, {r}) f32, device ms per call (issued from Python): kernel {k_ms:.5f} "
        f"({k_is:.5f}) | plain {p_ms:.5f} ({p_is:.5f}) | library None | bound {b_ms:.5f} "
        f"({b_by})")

    # prefill attention: 64 image + 128 text positions, 32 heads of 128, causal;
    # then the training step's batch 4 of 96 positions
    H, hd = 32, 128
    flash = {}
    for label, (b, s_) in (("prefill", (1, 64 + T)), ("train", (4, 96))):
        q, k, v = (randn((b, s_, H, hd), dtype=bf16) for _ in range(3))
        flash[label] = flash_timing(torch, F, fa_ops, fa_ref, q, k, v, f" ({label})")
    out["flash_attention"] = dict(flash["prefill"], shapes=flash)
    return out


# ---------------------------------------------------------------------------
# the ssm family: the SSD scan kernel and mamba2-130m's widths
# ---------------------------------------------------------------------------

def ssd_inputs(torch, gen, b, s, h, p, n, dtype):
    """The JAX harness's input scales: x·0.5, dt in [0.01, 0.2), A in (-2, -0.5]."""
    dev = gen.device
    x = (torch.randn((b, s, h, p), generator=gen, device=dev) * 0.5).to(dtype)
    dt = (torch.rand((b, s, h), generator=gen, device=dev) * 0.19 + 0.01).to(dtype)
    A = -(torch.rand((h,), generator=gen, device=dev) * 1.5 + 0.5)
    B, C = ((torch.randn((b, s, n), generator=gen, device=dev) * 0.3).to(dtype)
            for _ in range(2))
    return x, dt, A, B, C


def ssd_work(b, s, h, p, n, q, itemsize):
    """-> (bytes, f32 operations) the SSD scan needs at these shapes: each
    input read once and y written once; per (b, chunk) C·Bᵀ once (it does not
    depend on the head) over the causal pairs j <= i, and per head the masked
    product with x over those pairs, the carried state's read (C·h) on every
    chunk but the first (h = 0 there) and its update (B·xᵀ) on every chunk
    but the last (only y is returned), 2 operations a multiply-add."""
    pairs = 0
    rows = [min(q, s - c0) for c0 in range(0, s, q)]
    for r in rows:
        pairs += r * (r + 1) // 2
    carried = (s - rows[0]) + (s - rows[-1])   # steps of C·h reads + state updates
    ops = b * (2 * pairs * n + h * (2 * pairs * p + 2 * carried * n * p))
    n_bytes = itemsize * (2 * b * s * h * p + b * s * h + 2 * b * s * n) + 4 * h
    return n_bytes, ops


def mamba_parity(torch, harness, ssd_ops, ssd_ref, lora_ops, lora_ref, fm_ops, fm_ref):
    """The SSD kernel and its gradients against the plain version, and the
    LoRA and Fisher kernels at mamba2's widths. -> {kernel: max |err|}."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    main_err, n_cases, full = {}, 0, {}
    names = ("dx", "ddt", "dA", "dB", "dC")

    def rel(got, want):  # max |got - want| / max(1, ‖want‖∞), the harness's scale
        return float((got.double() - want.double()).abs().max()) / max(
            1.0, float(want.double().abs().max()))

    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for shape in harness.SSD_SHAPES + harness.FULL_SSD_SHAPES:
            b, s, h, p, n, q = shape
            is_full = shape in harness.FULL_SSD_SHAPES
            tol = harness.FULL_SSD_TOLERANCES if is_full else harness.SSD_TOLERANCES
            args = ssd_inputs(torch, gen, b, s, h, p, n, dtype)
            y_k = ssd_ops.ssd(*args, chunk=q)
            y_p = ssd_ref.ssd_chunked(*args, chunk=q)
            err = harness.check_close(y_k, y_p, dtype_name, f"ssd {shape}", tol)
            got = sq_loss_grads(lambda *a: ssd_ops.ssd(*a, chunk=q), *args)
            want = sq_loss_grads(lambda *a: ssd_ref.ssd_chunked(*a, chunk=q), *args)
            gerr = max(rel(g, w) for g, w in zip(got, want))
            for name, g, w in zip(names, got, want):
                harness.check_close(g, w, dtype_name, f"ssd grad {name} {shape}", tol)
            n_cases += 2
            if not is_full:
                continue
            line = (f"forward max |err| {err:.3e}, {rel(y_k, y_p):.3e} of max(1, ‖ref‖∞); "
                    f"gradients {gerr:.3e} (bound {tol[dtype_name]['atol_scale']})")
            if dtype_name == "float32":
                # both f32 paths against the same scan in float64
                a64 = [t.double() for t in args]
                y64 = ssd_ref.ssd_chunked(*a64, chunk=q)
                g64 = sq_loss_grads(lambda *a: ssd_ref.ssd_chunked(*a, chunk=q), *a64)
                line += (f"; against float64: forward kernel {rel(y_k, y64):.3e}, plain "
                         f"{rel(y_p, y64):.3e}; gradients Function "
                         f"{max(rel(g, w) for g, w in zip(got, g64)):.3e}, plain autograd "
                         f"{max(rel(g, w) for g, w in zip(want, g64)):.3e}")
            full[f"{dtype_name} {shape[:2]}"] = line
            if shape == harness.FULL_SSD_SHAPES[-1] and dtype_name == "bfloat16":
                main_err["ssd_scan"] = err
        for t, d, r, _ in harness.MAMBA_LORA_SHAPES:
            x, down, up = (torch.randn((t, d), generator=gen, device=dev).to(dtype),
                           torch.randn((d, r), generator=gen, device=dev) * 0.05,
                           torch.randn((r, d), generator=gen, device=dev) * 0.05)
            harness.check_close(lora_ops.lora_residual(x, down, up, scale=SCALE),
                                lora_ref.lora_residual(x, down, up, scale=SCALE), dtype_name,
                                f"lora t{t}d{d}r{r}")
            n_cases += 1
        for t, d, r, nb, _ in harness.MAMBA_GROUPED_SHAPES:
            x = torch.randn((t, d), generator=gen, device=dev).to(dtype)
            down = torch.randn((nb, d, r), generator=gen, device=dev) * 0.05
            up = torch.randn((nb, r, d), generator=gen, device=dev) * 0.05
            idx = torch.randint(-1, nb, (t,), generator=gen, device=dev, dtype=torch.int32)
            harness.check_close(lora_ops.grouped_lora_residual(x, down, up, idx, scale=SCALE),
                                lora_ref.grouped_lora_residual(x, down, up, idx, scale=SCALE),
                                dtype_name, f"grouped t{t}d{d}n{nb}")
            n_cases += 1
        for t, d, r, _ in harness.MAMBA_LORA_GRAD_SHAPES:
            x = torch.randn((t, d), generator=gen, device=dev).to(dtype)
            down = torch.randn((d, r), generator=gen, device=dev) * 0.05
            up = torch.randn((r, d), generator=gen, device=dev) * 0.05
            got = sq_loss_grads(lambda a, b_, c: lora_ops.lora_residual(a, b_, c, scale=SCALE),
                                x, down, up)
            want = sq_loss_grads(lambda a, b_, c: lora_ref.lora_residual(a, b_, c, scale=SCALE),
                                 x, down, up)
            for name, g, w in zip(("dx", "dA", "dB"), got, want):
                harness.check_close(g, w, dtype_name, f"lora grad {name} t{t}d{d}r{r}")
            n_cases += 1
        for k, n, _ in harness.MAMBA_FISHER_SHAPES:
            theta = torch.randn((k, n), generator=gen, device=dev).to(dtype)
            fisher = (torch.rand((k, n), generator=gen, device=dev) + 0.01).to(dtype)
            w = torch.rand((k,), generator=gen, device=dev) + 0.1
            harness.check_close(fm_ops.fisher_merge(theta, fisher, w),
                                fm_ref.fisher_merge(theta, fisher, w), dtype_name,
                                f"fisher_merge k{k}n{n}")
            num, den = torch.zeros(n, device=dev), torch.zeros(n, device=dev)
            pnum, pden = num.clone(), den.clone()
            for i in range(k):
                fm_ops.fisher_fold(num, den, theta[i], fisher[i], float(w[i]))
                fm_ref.fisher_fold(pnum, pden, theta[i], fisher[i], float(w[i]))
            harness.check_close(num, pnum, "float32", f"fisher_fold num k{k}n{n}")
            harness.check_close(den, pden, "float32", f"fisher_fold den k{k}n{n}")
            n_cases += 2
    torch.cuda.synchronize()
    log(f"[ssd-parity] {n_cases} kernel-vs-plain cases passed (SSD forward and gradients over "
        f"the harness grid and the full-width shapes; LoRA, grouped LoRA, LoRA gradients and "
        f"Fisher kernels at d_model 768; f32 and bf16)")
    for key, line in full.items():
        log(f"[ssd-parity] full width {key}: {line}")
    return main_err


def mamba_timings(torch, ssd_ops, ssd_ref, lora_ops, lora_ref, harness):
    """The SSD kernel at both full-width shapes and the LoRA kernel at d_model
    768, bf16 activations, beside their plain versions and bounds.
    -> (SSD kernel-table row, LoRA rows by shape)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    bf16 = torch.bfloat16
    shapes = {}
    for label, shape in zip(("serve", "train"), harness.FULL_SSD_SHAPES):
        b, s, h, p, n, q = shape
        args = ssd_inputs(torch, gen, b, s, h, p, n, bf16)
        (k_ms, k_is), (p_ms, p_is) = (time_ms(torch, lambda: ssd_ops.ssd(*args, chunk=q)),
                                      time_ms(torch, lambda: ssd_ref.ssd_chunked(*args, chunk=q)))
        n_bytes, n_ops = ssd_work(b, s, h, p, n, q, 2)
        b_ms, b_by = bound(n_bytes, n_ops, "f32")
        shapes[label] = dict(shape=list(shape), ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                             bound_by=b_by)
        log(f"[time] ssd_scan at x ({b}, {s}, {h}, {p}) bf16, N {n}, chunk {q} ({label}): "
            f"device ms per call (issued from Python): kernel {k_ms:.5f} ({k_is:.5f}) | plain "
            f"{p_ms:.5f} ({p_is:.5f}) | library None | bound {b_ms:.5f} ({b_by}; "
            f"{n_ops / 1e9:.4f} GFLOP f32, {n_bytes / 1e6:.3f} MB) | kernel at "
            f"{n_ops / k_ms / 1e9:.3f} TFLOP/s")
        if label == "train":
            # what a local step pays per layer: SSDScan (kernel forward, then the
            # plain forward recomputed and differentiated) against plain autograd.
            # A is frozen; x, dt, B and C lie downstream of the adapter.
            leaves = [t.detach().requires_grad_(i != 2) for i, t in enumerate(args)]
            g = torch.randn(args[0].shape, generator=gen, device=dev).to(bf16)

            def fwd_bwd(fn):
                return torch.autograd.grad(fn(*leaves, chunk=q),
                                           [t for t in leaves if t.requires_grad], g)

            (f_ms, _), (a_ms, _) = (time_ms(torch, lambda: fwd_bwd(ssd_ops.ssd), iters=10),
                                    time_ms(torch, lambda: fwd_bwd(ssd_ref.ssd_chunked),
                                            iters=10))
            shapes[label].update(fwd_bwd_ms=f_ms, plain_fwd_bwd_ms=a_ms)
            log(f"[time] ssd_scan forward + backward at x ({b}, {s}, {h}, {p}) bf16 (train): "
                f"device ms: SSDScan {f_ms:.5f} (kernel forward + plain recompute and backward) "
                f"| plain autograd {a_ms:.5f} | so the backward alone about "
                f"{a_ms - p_ms:.5f} and the kernel forward adds {f_ms - a_ms:.5f}")
    lora = {}
    for t, d, r, _ in harness.MAMBA_LORA_SHAPES:
        x = torch.randn((t, d), generator=gen, device=dev).to(bf16)
        A = torch.randn((d, r), generator=gen, device=dev) * 0.05
        Bm = torch.randn((r, d), generator=gen, device=dev) * 0.05
        lora[f"x ({t}, {d})"] = lora_timing(torch, lora_ops, lora_ref, x, A, Bm, " (mamba2-130m)")
    kernel_breakdown(torch, lambda: lora_ops.lora_residual(x, A, Bm, scale=SCALE),
                     f"lora_residual at x {tuple(x.shape)} (mamba2-130m)")
    main = shapes["train"]
    return {"ssd_scan": dict(ms=main["ms"], plain_ms=main["plain_ms"], library_ms=None,
                             bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                             shapes=shapes)}, lora


def breakdown(torch, get_config, init_backbone, synth, make_requests, Engine):
    """Device busy share and device time by kernel over one prefill and a few
    decode steps at full width, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    cfg = get_config("llava-1.5-7b").with_(use_pallas=True)
    backbone = init_backbone(cfg, seed=0, device="cuda")
    names = ["tenant0", "tenant1"]
    tenants = synth(0, cfg, names, "cuda")
    reqs = make_requests(cfg, names, 8, 128, 5, 0)
    kw = dict(max_slots=8, prefill_len=128, max_new_tokens=5, adapter_slots=8,
              adapter_loader=tenants.__getitem__, use_pallas_grouped=True)
    Engine(cfg, backbone, **kw).run(reqs[:1])  # warm-up
    eng = Engine(cfg, backbone, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    profile_summary(torch, prof, wall,
                    f"8 requests x 5 tokens ({eng.stats['prefills']} prefills, "
                    f"{eng.stats['decode_steps']} decode steps)")


def step_profile(torch, tr, st):
    """Device busy share and device time by kernel over one full-width local
    step (forward, backward, AdamW, float(loss)), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    cfg, server = st["cfg"], st["server"]
    adp = st["res"].server.global_adapters
    opt = tr["adamw_init"](adp)

    def step():
        return float(tr["client"].train_step(cfg, tr["get_strategy"]("fednano"), st["hp"],
                                              server.backbone, adp, opt, st["train"][0][0],
                                              adp)[2])

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    profile_summary(torch, prof, wall, "one full-width local step")


def profile_summary(torch, prof, wall, what):
    """Log the busy share and the largest device times by kernel name."""
    # device activities only (kernels, copies, sets): a CPU op's device time
    # would count its kernels a second time
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not spans:
        log(f"[profile] {what}: the profiler recorded no device activity: busy share not "
            "measured")
        return
    busy_us, reach = 0.0, float("-inf")
    by_name = {}
    for start, end, name in sorted(spans):
        busy_us += max(0.0, end - max(start, reach))  # union of the intervals
        reach = max(reach, end)
        t, n = by_name.get(name, (0.0, 0))
        by_name[name] = (t + end - start, n + 1)
    log(f"[profile] {what} under the profiler: wall {1e3 * wall:.1f} ms, device busy "
        f"{busy_us / 1e3:.1f} ms, busy share {busy_us / 1e6 / wall:.3f} "
        f"({len(spans)} device activities)")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"[profile]   {t / 1e3:9.3f} ms  {n:6d} x  {name[:90]}")
    # the port's kernels by the names of their CUDA functions
    ours = {"flash_attention": ("flash_fwd",), "lora_residual": ("lora_", "tc::"),
            "ssd_scan": ("ssd_",), "fisher": ("fisher_",)}
    parts = []
    for kernel, keys in ours.items():
        t = sum(v[0] for name, v in by_name.items() if any(key in name for key in keys))
        n = sum(v[1] for name, v in by_name.items() if any(key in name for key in keys))
        if n:
            parts.append(f"{kernel} {t / 1e3:.3f} ms over {n} launches "
                         f"({t / busy_us:.3f} of busy)")
    log(f"[profile]   the port's kernels: {'; '.join(parts) or 'none'}")


SOURCES = {
    "lora_residual": ("src/repro_torch/csrc/lora.cu", "src/repro/kernels/lora/lora.py:49"),
    "grouped_lora_residual": ("src/repro_torch/csrc/lora.cu",
                              "src/repro/kernels/lora/lora.py:115"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/flash_attention.py:121"),
    "fisher_merge": ("src/repro_torch/csrc/fisher_merge.cu",
                     "src/repro/kernels/fisher_merge/fisher_merge.py:100"),
    "fisher_fold": ("src/repro_torch/csrc/fisher_merge.cu",
                    "src/repro/kernels/fisher_merge/fisher_merge.py:62"),
    "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan/ssd_scan.py:81"),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on an NVIDIA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch.nn.functional as F

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import HyperParams, init_server, run_federated
    from repro_torch.core import client as client_lib
    from repro_torch.core.adapters import fednano_loss
    from repro_torch.core.fisher import fisher_pass
    from repro_torch.data import make_federated_data
    from repro_torch.kernels import build, harness
    from repro_torch.kernels.fisher_merge import ops as fm_ops
    from repro_torch.kernels.fisher_merge import ref as fm_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.lora import ops as lora_ops
    from repro_torch.kernels.lora import ref as lora_ref
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.launch.serve import make_requests, synth_tenant_adapters
    from repro_torch.models.model import init_backbone
    from repro_torch.optim import adamw_init
    from repro_torch.serving import ServingEngine
    from repro_torch.strategies import get_strategy

    t_start = time.perf_counter()
    card = card_line()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    lib = build.build()
    build.library()
    log(f"[build] {lib.parent.name}: {time.perf_counter() - t0:.1f} s (nvcc for each source "
        "in parallel, then link)")
    ptxas = [ln.strip() for ln in (lib.parent / "build.log").read_text().splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    for ln in ptxas:
        log(f"[ptxas] {ln}")

    main_err = parity(torch, harness, lora_ops, lora_ref, fa_ops, fa_ref)
    serving_smoke(torch, get_smoke_config, init_backbone, synth_tenant_adapters,
                  make_requests, ServingEngine)
    counters = {"lora_residual": lora_ops.lora_residual,
                "grouped_lora_residual": lora_ops.grouped_lora_residual,
                "flash_attention": fa_ops.flash_attention,
                "fisher_merge": fm_ops.fisher_merge,
                "fisher_fold": fm_ops.fisher_fold,
                "ssd_scan": ssd_ops.ssd}
    launches = {"serve": serving_full(torch, get_config, init_backbone, synth_tenant_adapters,
                                      make_requests, ServingEngine, counters)}
    torch.cuda.empty_cache()

    tr = dict(get_config=get_config, get_smoke_config=get_smoke_config,
              HyperParams=HyperParams, init_server=init_server, run_federated=run_federated,
              client=client_lib, fednano_loss=fednano_loss, fisher_pass=fisher_pass,
              make_federated_data=make_federated_data, adamw_init=adamw_init,
              get_strategy=get_strategy)
    main_err.update(training_parity(torch, harness, lora_ops, lora_ref, fa_ops, fa_ref,
                                    fm_ops, fm_ref))
    training_smoke(torch, tr)
    st, train_launches = training_full(torch, tr, counters)
    launches.update(train_launches)
    training_check(torch, tr, st, counters)

    times = timings(torch, F, lora_ops, lora_ref, fa_ops, fa_ref)
    times.update(training_timings(torch, F, tr, st, fm_ops, fm_ref, lora_ops, lora_ref,
                                  fa_ops, fa_ref))
    breakdown(torch, get_config, init_backbone, synth_tenant_adapters, make_requests,
              ServingEngine)
    step_profile(torch, tr, st)
    del st
    torch.cuda.empty_cache()

    # the ssm family: mamba2-130m through the SSD scan kernel
    main_err.update(mamba_parity(torch, harness, ssd_ops, ssd_ref, lora_ops, lora_ref,
                                 fm_ops, fm_ref))
    serving_smoke(torch, get_smoke_config, init_backbone, synth_tenant_adapters,
                  make_requests, ServingEngine, arch=MAMBA)
    launches["serve_mamba2"] = serving_full(torch, get_config, init_backbone,
                                            synth_tenant_adapters, make_requests, ServingEngine,
                                            counters, arch=MAMBA)
    torch.cuda.empty_cache()
    training_smoke(torch, tr, arch=MAMBA)
    st, train_launches = training_full(torch, tr, counters, arch=MAMBA)
    launches.update(train_launches)
    training_check(torch, tr, st, counters)
    ssd_times, lora_times = mamba_timings(torch, ssd_ops, ssd_ref, lora_ops, lora_ref, harness)
    times.update(ssd_times)
    times["lora_residual"]["shapes"].update(lora_times)
    loop_timings(torch, tr, st)
    step_profile(torch, tr, st)

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        t = times[name]
        by_path = {path: n[name] for path, n in launches.items()}
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": sum(by_path.values()), "launches_by_path": by_path,
                        "max_abs_err": main_err[name],
                        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                        **({"shapes": t["shapes"]} if "shapes" in t else {})})
    log(f"[done] {time.perf_counter() - t_start:.1f} s on {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
