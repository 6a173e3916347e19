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
6. Time each kernel at its main-path shape (CUDA events), beside its plain
   version, one PyTorch library call where one computes the same function,
   and the H100 bound; print them as one JSON line at the end.
7. Profile a short full-width run (torch.profiler): device busy share and
   device time by kernel.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA card, or
without the repository beside this file, it fails before printing a result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
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
    names = ["tenant0", "tenant1"]
    kw = dict(max_slots=3, prefill_len=8, max_new_tokens=6, adapter_slots=4)
    runs = {}
    for dev in ("cuda", "cpu"):
        cfg = get_smoke_config("llava-1.5-7b").with_(use_pallas=True)
        backbone = init_backbone(cfg, seed=1, device="cpu")
        tenants = synth(1, cfg, names, "cpu")
        if dev == "cuda":
            backbone = _map(lambda t: t.to(dev), backbone)
            tenants = _map(lambda t: t.to(dev), tenants)
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


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def serving_full(torch, get_config, init_backbone, synth, make_requests, Engine, counters):
    """-> launches per kernel in the main-path run."""
    cfg = get_config("llava-1.5-7b").with_(use_pallas=True)
    t0 = time.perf_counter()
    backbone = init_backbone(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(backbone))
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
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
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
    backbone32 = _map(lambda t: t.float(), backbone)
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
    from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
    from repro_torch.kernels.lora import ops as lora_ops, ref as lora_ref

    swaps = [(lora_ops, "lora_residual", lora_ref.lora_residual),
             (lora_ops, "grouped_lora_residual", lora_ref.grouped_lora_residual),
             (fa_ops, "flash_attention", fa_ref.attention)]
    try:
        for mod, name, plain in swaps:
            setattr(mod, name, plain)
        yield
    finally:
        for mod, name, _ in swaps:
            setattr(mod, name, counters[name])


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


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
    # device activities only (kernels, copies, sets): a CPU op's device time
    # would count its kernels a second time
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not spans:
        log("[profile] the profiler recorded no device activity: busy share not measured")
        return
    busy_us, reach = 0.0, float("-inf")
    by_name = {}
    for start, end, name in sorted(spans):
        busy_us += max(0.0, end - max(start, reach))  # union of the intervals
        reach = max(reach, end)
        t, n = by_name.get(name, (0.0, 0))
        by_name[name] = (t + end - start, n + 1)
    log(f"[profile] 8 requests x 5 tokens under the profiler: wall {1e3 * wall:.1f} ms, "
        f"device busy {busy_us / 1e3:.1f} ms, busy share {busy_us / 1e6 / wall:.3f} "
        f"({eng.stats['prefills']} prefills, {eng.stats['decode_steps']} decode steps, "
        f"{len(spans)} device activities)")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"[profile]   {t / 1e3:9.3f} ms  {n:6d} x  {name[:90]}")


SOURCES = {
    "lora_residual": ("src/repro_torch/csrc/lora.cu", "src/repro/kernels/lora/lora.py:49"),
    "grouped_lora_residual": ("src/repro_torch/csrc/lora.cu",
                              "src/repro/kernels/lora/lora.py:115"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/flash_attention.py:121"),
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
    from repro_torch.kernels import build, harness
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.lora import ops as lora_ops
    from repro_torch.kernels.lora import ref as lora_ref
    from repro_torch.launch.serve import make_requests, synth_tenant_adapters
    from repro_torch.models.model import init_backbone
    from repro_torch.serving import ServingEngine

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
                "flash_attention": fa_ops.flash_attention}
    launches = serving_full(torch, get_config, init_backbone, synth_tenant_adapters,
                            make_requests, ServingEngine, counters)
    times = timings(torch, F, lora_ops, lora_ref, fa_ops, fa_ref)
    breakdown(torch, get_config, init_backbone, synth_tenant_adapters, make_requests,
              ServingEngine)

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        t = times[name]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": main_err[name],
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
