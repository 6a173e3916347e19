#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout; needs one CUDA card

Phases, in order; any failure ends the run with a non-zero exit code:

1. Print the card's name and power limit; switch TF32 off.
2. Build the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a).
3. Kernel parity: every kernel against its plain PyTorch version on the
   card, f32 and bf16, over the port's copy of the kernel-harness grids and
   the full-width llava-1.5-7b shapes, at the harness tolerances; the grouped
   kernel's rows bit-identical to the single-adapter kernel in f32, and its
   identity rows exactly x.
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
   and the H100 bound; the gradients beside autograd through the plain
   versions and SDPA; and the training step, Fisher batch, merge and round
   end to end. The kernels' line is printed at the end.
11. Profile a short full-width serving run and one full-width local step
   (torch.profiler): device busy share and device time by kernel.

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
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}
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


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernel parity
# ---------------------------------------------------------------------------

def parity(torch, harness, lora_ops, lora_ref, fa_ops, fa_ref):
    """-> {kernel: max |err| at its main-path shape in bf16}."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    main_err = {}
    n_cases = 0
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for t, d, r, _ in harness.LORA_SHAPES + harness.FULL_LORA_SHAPES:
            x, down, up = randn((t, d), dtype=dtype), randn((d, r), 0.05), randn((r, d), 0.05)
            got = lora_ops.lora_residual(x, down, up, scale=SCALE)
            err = harness.check_close(got, lora_ref.lora_residual(x, down, up, scale=SCALE),
                                      dtype_name, f"lora t{t}d{d}r{r}")
            n_cases += 1
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
        for shape in harness.FLASH_SHAPES + harness.FULL_FLASH_SHAPES:
            label, b, sq, sk, h, hkv, d, causal, window, cap, _, _ = shape
            q = randn((b, sq, h, d), dtype=dtype)
            k, v = randn((b, sk, hkv, d), dtype=dtype), randn((b, sk, hkv, d), dtype=dtype)
            got, got_lse = fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                                  softcap=cap, return_lse=True)
            want, want_lse = fa_ref.attention(q, k, v, causal=causal, window=window,
                                              softcap=cap, return_lse=True)
            err = harness.check_close(got, want, dtype_name, f"flash {label}")
            harness.check_close(got_lse, want_lse, dtype_name, f"flash {label} lse")
            n_cases += 1
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
    log(f"[parity] {n_cases} kernel-vs-plain cases passed (f32 and bf16); "
        f"main-path bf16 max |err|: {json.dumps(main_err)}")
    return main_err


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def serving_smoke(torch, get_smoke_config, init_backbone, synth, make_requests, Engine):
    """Smoke llava on the card (kernels, f32) vs on the CPU (plain versions)."""
    from repro_torch.utils import tree_map

    names = ["tenant0", "tenant1"]
    kw = dict(max_slots=3, prefill_len=8, max_new_tokens=6, adapter_slots=4)
    runs = {}
    for dev in ("cuda", "cpu"):
        cfg = get_smoke_config("llava-1.5-7b").with_(use_pallas=True)
        backbone = init_backbone(cfg, seed=1, device="cpu")
        tenants = synth(1, cfg, names, "cpu")
        if dev == "cuda":
            backbone = tree_map(lambda t: t.to(dev), backbone)
            tenants = tree_map(lambda t: t.to(dev), tenants)
        eng = Engine(cfg, backbone, adapter_loader=tenants.__getitem__,
                     use_pallas_grouped=True, **kw)
        reqs = make_requests(cfg, names, 6, kw["prefill_len"], kw["max_new_tokens"], 1)
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
    log(f"[smoke] smoke llava f32: card (kernels) == CPU (plain) tokens for 6 requests; "
        f"prefill logits max |err| {err:.3e} (bound {bound:.3e})")


def serving_full(torch, get_config, init_backbone, synth, make_requests, Engine, counters):
    """-> launches per kernel in the main-path run."""
    from repro_torch.utils import tree_leaves, tree_map

    cfg = get_config("llava-1.5-7b").with_(use_pallas=True)
    t0 = time.perf_counter()
    backbone = init_backbone(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(backbone))
    log(f"[serve] llava-1.5-7b backbone: {n_params / 1e9:.3f} B params "
        f"({cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.dtype}) drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    names = [f"tenant{i}" for i in range(4)]
    tenants = synth(0, cfg, names, "cuda")
    kw = dict(max_slots=8, prefill_len=128, max_new_tokens=16, adapter_slots=8,
              adapter_loader=tenants.__getitem__)
    reqs = make_requests(cfg, names, 16, kw["prefill_len"], kw["max_new_tokens"], 0)

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
    if not all(launches[n] for n in SERVING_KERNELS):
        raise AssertionError(f"a kernel of the serving path never launched: {launches}")
    st = eng.stats
    n_tok = sum(len(c.tokens) for c in done.values())
    log(f"[serve] {len(reqs)} requests, {n_tok} tokens in {wall:.3f} s: "
        f"{n_tok / wall:.1f} tokens/s | prefill {1e3 * st['prefill_s'] / st['prefills']:.2f} "
        f"ms/request | decode step {1e3 * st['decode_s'] / st['decode_steps']:.2f} ms "
        f"({st['decode_steps']} steps, occupancy {eng.mean_occupancy():.2f}/8) | "
        f"peak memory {peak / 2**30:.2f} GiB | launches {json.dumps(launches)}")

    kernel16 = [eng.prefill_logits(r) for r in reqs]
    done_plain, plain16 = run_plain_versions(cfg, backbone, Engine, kw, reqs, counters)
    worst = hold(torch, cfg.dtype, reqs, kernel16, plain16)
    log(f"[serve] bf16, kernels vs their plain versions: prefill logits max |err| / ‖ref‖∞ = "
        f"{worst:.3e} (limit {LOGIT_TOL['bfloat16']}); {agreement(reqs, done, done_plain)}")

    # for information: the model's plain path (use_pallas off: bf16 adapter
    # products, probabilities cast to bf16 before the product with V)
    jnp_path = Engine(cfg.with_(use_pallas=False), backbone, use_pallas_grouped=False, **kw)
    done_jnp = jnp_path.run(reqs)
    jnp16 = [jnp_path.prefill_logits(r) for r in reqs]
    log(f"[serve] bf16, kernels vs the use_pallas=False path: prefill logits max |err| / "
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
    log(f"[serve] f32, kernels vs their plain versions: prefill logits max |err| / ‖ref‖∞ = "
        f"{worst:.3e} (limit {LOGIT_TOL['float32']}); {agreement(reqs, done32, done32_plain)}")
    log(f"[serve] bf16 runs vs the f32 plain run, prefill logits max |err| / ‖ref‖∞: "
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

    swaps = [(lora_ops, "lora_residual", lora_ref.lora_residual),
             (lora_ops, "grouped_lora_residual", lora_ref.grouped_lora_residual),
             (fa_ops, "flash_attention", fa_ref.attention),
             (fm_ops, "fisher_merge", fm_ref.fisher_merge),
             (fm_ops, "fisher_fold", fm_ref.fisher_fold)]
    try:
        for mod, name, plain in swaps:
            setattr(mod, name, plain)
        yield
    finally:
        for mod, name, _ in swaps:
            setattr(mod, name, counters[name])


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


def training_smoke(torch, tr):
    """Two FedNano rounds of smoke llava in f32: card (kernels) vs CPU (plain)."""
    from repro_torch.utils import tree_map

    cfg = tr["get_smoke_config"]("llava-1.5-7b").with_(use_pallas=True)
    hp = tr["HyperParams"](**TRAIN_HP)
    data_kw = dict(n_clients=2, examples_per_client=16, batch_size=4, seq_len=16, seed=0)
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
    log(f"[train-smoke] smoke llava f32, 2 rounds: card (kernels) vs CPU (plain): round "
        f"losses {gl} vs {cl}, max rel err {loss_err:.3e}; first step loss {step_loss:.3e}, "
        f"grads {step_grad:.3e} (bound 1e-5); global adapters after 2 rounds {adp_err:.3e} "
        f"(bound 1e-5); comm totals equal")


def training_full(torch, tr, counters):
    """The slice's main path at full width. -> (state for later phases,
    launches per kernel on its runs)."""
    from repro_torch.utils import tree_leaves

    cfg = tr["get_config"]("llava-1.5-7b").with_(use_pallas=True)
    hp = tr["HyperParams"](**TRAIN_HP)
    t0 = time.perf_counter()
    server = tr["init_server"](cfg, seed=0, device="cuda")
    train, evald, _ = tr["make_federated_data"](cfg, device="cuda", **TRAIN_DATA)
    torch.cuda.synchronize()
    b0 = train[0][0]
    tokens_per_step = b0.tokens.shape[0] * (b0.tokens.shape[1] + b0.patches.shape[1])
    log(f"[train] llava-1.5-7b backbone {cfg.dtype}, rank-{cfg.adapter.rank} "
        f"{cfg.adapter.dtype} adapters {list(cfg.adapter.modalities)}, data "
        f"{[len(train[c]) for c in sorted(train)]} train / {[len(evald[c]) for c in sorted(evald)]}"
        f" eval batches per client, batch {tuple(b0.tokens.shape)} tokens + "
        f"{tuple(b0.patches.shape)} patches ({tokens_per_step} positions a step); drawn in "
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
    for name in ("lora_residual", "flash_attention", "fisher_merge"):
        if launches[name] <= 0:
            raise AssertionError(f"the {name} kernel never launched on the training path: "
                                 f"{launches}")
    log(f"[train] fednano, 2 clients x 2 rounds x ({hp.local_steps} steps + "
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
    log(f"[train] agg_chunk=1, round 0 folded one client at a time by fisher_fold: loss "
        f"{loss0} (merge run {losses[0]}); streamed merge vs fisher_merge of the same uploads "
        f"{fold_err:.3e} of ‖ref‖∞ (bound 1e-6); wall {wall_f:.3f} s | launches "
        f"{json.dumps(launches_f)}")
    launches_by_path = {"train": {n: launches[n] + launches_f[n] for n in launches}}
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
        log(f"[train-check] {dtype} {label}: loss kernels {lk:.7f} plain {lp:.7f} (rel "
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
    log(f"[train-check] bf16 whole run, kernels vs plain versions: round losses {kl} vs {pl} "
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
    cfg, hp, server, train = st["cfg"], st["hp"], st["server"], st["train"]
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

    # end to end at full width
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
    log(f"[train-time] local step (forward, backward, AdamW, float(loss)) {step_ms:.2f} ms: "
        f"{st['tokens_per_step'] / step_ms * 1e3:.1f} trained tokens/s | Fisher-pass batch "
        f"{fisher_ms:.2f} ms | server merge (4 leaves, fisher_merge) {merge_ms:.3f} ms | "
        f"round wall (2 clients, no eval) {round_s:.3f} s | peak memory of the main run "
        f"{st['peak'] / 2**30:.2f} GiB")
    return out


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


def timings(torch, F, lora_ops, lora_ref, fa_ops, fa_ref):
    """Each kernel at its main-path shape: llava-1.5-7b, prefill_len 128,
    64 patches, 8 decode slots, 8 adapter slots, rank 64, bf16 activations."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def row(kernel, plain, library, bound_ms, bound_by, shape):
        (k_ms, k_is), (p_ms, p_is) = time_ms(torch, kernel), time_ms(torch, plain)
        l_ms, l_is = time_ms(torch, library) if library else (None, None)
        return dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=bound_ms,
                    bound_by=bound_by, shape=shape, issued=(k_is, p_is, l_is))

    bf16 = torch.bfloat16
    out = {}
    T, D, r, N = 128, 4096, 64, 8

    # text NanoAdapter at prefill: x (T, D) bf16, adapters f32
    x, A, B = randn((T, D), dtype=bf16), randn((D, r), 0.05), randn((r, D), 0.05)
    A16, B16 = A.to(bf16), B.to(bf16)
    y = lora_ops.lora_residual(x, A, B, scale=SCALE)
    b_ms, b_by = bound(nbytes(x, A, B, y), 4 * T * D * r + 2 * T * D, "f32")
    out["lora_residual"] = row(
        lambda: lora_ops.lora_residual(x, A, B, scale=SCALE),
        lambda: lora_ref.lora_residual(x, A, B, scale=SCALE),
        lambda: torch.addmm(x, x @ A16, B16, alpha=SCALE),
        b_ms, b_by, f"x ({T}, {D}) bf16, r {r}")

    # text bank at decode: 8 slots, 4 tenants + 1 base row + adapters reused
    xs = randn((N, D), dtype=bf16)
    downs, ups = randn((N, D, r), 0.05), randn((N, r, D), 0.05)
    idx = torch.tensor([0, 1, 2, 3, 0, 1, 2, -1], dtype=torch.int32, device=dev)
    used = sorted({int(i) for i in idx.tolist() if 0 <= i < N})
    live = int((idx >= 0).sum())
    ys = lora_ops.grouped_lora_residual(xs, downs, ups, idx, scale=SCALE)
    b_ms, b_by = bound(nbytes(xs, ys, idx) + len(used) * nbytes(downs[0], ups[0]),
                       4 * live * D * r + 2 * live * D, "f32")
    out["grouped_lora_residual"] = row(
        lambda: lora_ops.grouped_lora_residual(xs, downs, ups, idx, scale=SCALE),
        lambda: lora_ref.grouped_lora_residual(xs, downs, ups, idx, scale=SCALE),
        None, b_ms, b_by, f"x ({N}, {D}) bf16, idx {idx.tolist()}, bank ({N}, {D}, {r}) f32")

    # prefill attention: 64 image + 128 text positions, 32 heads of 128, causal
    S, H, hd = 64 + T, 32, 128
    q, k, v = (randn((1, S, H, hd), dtype=bf16) for _ in range(3))
    o, lse = fa_ops.flash_attention(q, k, v, causal=True, return_lse=True)
    pairs = S * (S + 1) // 2 * H
    b_ms, b_by = bound(nbytes(q, k, v, o, lse), 4 * hd * pairs, "bf16")
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    out["flash_attention"] = row(
        lambda: fa_ops.flash_attention(q, k, v, causal=True),
        lambda: fa_ref.attention(q, k, v, causal=True),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
        b_ms, b_by, f"q/k/v (1, {S}, {H}, {hd}) bf16 causal")
    for name, t in out.items():
        log(f"[time] {name} at {t['shape']}, device ms per call (issued from Python): "
            f"kernel {t['ms']:.5f} ({t['issued'][0]:.5f}) | plain {t['plain_ms']:.5f} "
            f"({t['issued'][1]:.5f}) | library {t['library_ms']} ({t['issued'][2]}) | "
            f"bound {t['bound_ms']:.5f} ({t['bound_by']})")
    return out


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
}
SERVING_KERNELS = ("lora_residual", "grouped_lora_residual", "flash_attention")


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
                "fisher_fold": fm_ops.fisher_fold}
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

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        t = times[name]
        by_path = {path: n[name] for path, n in launches.items()}
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": sum(by_path.values()), "launches_by_path": by_path,
                        "max_abs_err": main_err[name],
                        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    log(f"[done] {time.perf_counter() - t_start:.1f} s on {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
