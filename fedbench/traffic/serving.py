"""Generator of the multi-tenant serving mixes: a closed loop of ``clients``
callers over the port's ``ServingEngine``, each sending its next request as
soon as its last one completes.

Requests come from a pool of ``pool`` (prompt length, output length, tenant)
triples: the lengths are the lognormal quantiles at (i + 1/2)/pool, clipped,
and the tenants a fixed count for each (a Zipf share of the tenant traffic,
``base_share`` with no adapter), each column shuffled by the seed so that
every ``block`` consecutive requests take one value of each of ``block``
strata. So every seed serves the same population of sizes, in another
order; a window meets nearly all of it, though the order still moves its
work by a few per cent from seed to seed. Prompt tokens are drawn from the
seed. The first request of each caller is cut to a uniform
share of its output length, so that completions are spread from the start.

The harness drives the engine's two halves itself: ``submit`` and
``_admit`` one request at a time (its first token is ready when the prefill's
host read returns), then ``_step`` (one token for every active request).
Each token is stamped with the host clock when it is ready; ``latencies``
names what a cell may report of them. Set-up runs the
loop until ``warmup_completions`` requests have completed; the window then
runs from a step's end to the first step's end at least ``seconds`` later.

Mix keys: ``clients``, ``max_slots``, ``prefill_len``, ``max_new_tokens``,
``tenants``, ``zipf_s``, ``base_share``, ``adapter_up_std`` (the tenants'
drawn up-projections), ``prompt`` and ``output`` ({median, sigma, min, max}),
``pool``, ``block``, ``warmup_completions``,
``reference_tokens`` (served tokens the reference judges, at least),
``reference_max_requests``.
"""
from __future__ import annotations

import sys
import time
from collections import deque
from statistics import NormalDist
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from fedbench import families, harness
from fedbench.reference import serve as ref_serve
from fedbench.reference.precision import Prec
from fedbench.weights import draw_adapters, draw_backbone, sub_seed


def lengths(spec: dict, n: int) -> np.ndarray:
    """The lognormal's quantiles at (i + 1/2)/n, rounded and clipped."""
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    x = np.round(spec["median"] * np.exp(spec["sigma"] * z))
    return np.clip(x, spec["min"], spec["max"]).astype(np.int64)


def stratified(values: np.ndarray, block: int, rng) -> np.ndarray:
    """``values`` in an order drawn from ``rng`` in which every ``block``
    consecutive entries hold one value of each of ``block`` strata (the
    sorted values cut in ``block`` equal runs): any stretch of requests
    meets nearly the same population, whatever the seed."""
    v = np.sort(values)
    per = len(v) // block
    strata = v[: per * block].reshape(block, per)
    picks = np.stack([rng.permutation(per) for _ in range(block)])
    out = strata[np.arange(block)[:, None], picks].T
    for row in out:
        rng.shuffle(row)
    return out.reshape(-1)


def make_pool(cfg: dict, mix: dict, seed: int):
    """-> (prompt lengths, output lengths, tenant index or -1, token ids of
    all prompts end to end, offsets), each column stratified by ``block``."""
    n, block = mix["pool"], mix["block"]
    rng = np.random.RandomState(sub_seed(seed, "pool") % 2**32)
    plen = stratified(lengths(mix["prompt"], n), block, rng)
    olen = stratified(lengths(mix["output"], n), block, rng)
    w = 1.0 / np.arange(1, mix["tenants"] + 1) ** mix["zipf_s"]
    share = np.concatenate([[mix["base_share"]], (1 - mix["base_share"]) * w / w.sum()])
    counts = np.floor(share * n).astype(int)
    counts[0] += n - counts.sum()
    tenant = stratified(np.repeat(np.arange(-1, mix["tenants"]), counts), block, rng)
    tokens = rng.randint(0, cfg["vocab_size"], size=int(plen.sum())).astype(np.int64)
    offsets = np.concatenate([[0], np.cumsum(plen)])
    return plen, olen, tenant, tokens, offsets


class Log:
    """Per request: tenant, prompt length, submission time, token times."""

    def __init__(self):
        self.submit: Dict[int, float] = {}
        self.times: Dict[int, List[float]] = {}
        self.done_at: Dict[int, float] = {}
        self.tokens: Dict[int, List[int]] = {}


def run(ctx: harness.Ctx) -> dict:
    from repro_torch.serving import Request, ServingEngine

    cell, mix, cfg, dev = ctx.cell, ctx.cell.traffic, ctx.cell.cfg, ctx.device
    fam = families.load(cfg)
    s = fam.shape_of(cfg)
    pcfg = harness.port_config(cfg, cell.config_name)
    backbone = draw_backbone(fam.leaves(cfg), ctx.seed, dev, getattr(torch, cfg["torch_dtype"]))
    mods = cfg["nano_adapter"]["modalities"]
    tenant_adapters = draw_adapters(s, mods, mix["tenants"], ctx.seed, "tenants", dev,
                                    up_std=mix["adapter_up_std"])
    names = [f"tenant{i}" for i in range(mix["tenants"])]
    plen, olen, tenant, tokens, offsets = make_pool(cfg, mix, ctx.seed)
    engine = ServingEngine(pcfg, backbone, max_slots=mix["max_slots"],
                           prefill_len=mix["prefill_len"], max_new_tokens=mix["max_new_tokens"],
                           adapter_slots=mix["tenants"], use_pallas_grouped=True)
    for name, adp in zip(names, tenant_adapters):
        engine.cache.put(name, adp)

    clients = mix["clients"]
    rng = np.random.RandomState(sub_seed(ctx.seed, "first") % 2**32)
    first_cut = rng.permutation((np.arange(clients) + 0.5) / clients)
    log = Log()
    next_id = 0
    pending: deque = deque()
    requests: Dict[int, Request] = {}

    def new_request(now: float) -> None:
        nonlocal next_id
        i = next_id % mix["pool"]
        budget = int(olen[i])
        if next_id < clients:
            budget = max(1, int(np.ceil(first_cut[next_id] * budget)))
        r = Request(rid=next_id, tenant=names[tenant[i]] if tenant[i] >= 0 else None,
                    prompt=tokens[offsets[i]:offsets[i + 1]].astype(np.int32),
                    max_new_tokens=budget)
        requests[next_id] = r
        log.submit[next_id] = now
        pending.append(r)
        next_id += 1

    active: Dict[int, Request] = {}
    steps: List[tuple] = []            # per decode step: (end time, tenant rows, adapters, positions)
    prefills: List[tuple] = []         # per prefill: (end time, prompt length, adapted)

    def complete(done: dict, now: float) -> None:
        for rid, comp in done.items():
            active.pop(rid, None)
            log.done_at[rid] = now
            log.tokens[rid] = list(comp.tokens)
            new_request(now)

    def iterate() -> float:
        while pending and engine.slots.n_free > 0:
            r = pending.popleft()
            with record_function("fedbench.admit"):
                done: dict = {}
                engine.submit(r)
                engine._admit(done)
            now = time.perf_counter()
            log.times[r.rid] = [now]
            prefills.append((now, len(r.prompt), r.tenant is not None))
            if done:
                complete(done, now)
            else:
                active[r.rid] = r
        if not active:
            return time.perf_counter()
        rows = list(active.values())
        with record_function("fedbench.step"):
            done = {}
            engine._step(done)
        now = time.perf_counter()
        tenants_in = {r.tenant for r in rows if r.tenant is not None}
        steps.append((now, sum(r.tenant is not None for r in rows), len(tenants_in),
                      [len(r.prompt) + len(log.times[r.rid]) - 1 for r in rows]))
        for r in rows:
            log.times[r.rid].append(now)
        complete(done, now)
        return now

    t0 = time.perf_counter()
    for _ in range(clients):
        new_request(t0)
    while len(log.done_at) < mix["warmup_completions"]:
        iterate()
    tracer = None
    if ctx.trace:
        from fedbench.tracing import Tracer
        tracer = Tracer()
        tracer.start()
    if dev.startswith("cuda"):
        torch.cuda.synchronize(dev)
    t_open = time.perf_counter()
    if tracer is not None:
        tracer.mark("fedbench.open")
    stats0 = dict(engine.stats)
    now = t_open
    while now - t_open < ctx.seconds:
        now = iterate()
    t_close = now
    if tracer is not None:
        tracer.mark("fedbench.close")
        tracer.stop()
    stats1 = dict(engine.stats)
    peak = torch.cuda.max_memory_allocated(dev) if dev.startswith("cuda") else 0
    del engine
    summary = tracer.summary() if tracer is not None else None
    if dev.startswith("cuda"):
        torch.cuda.empty_cache()

    inside = lambda t: t_open < t <= t_close
    n_tokens = sum(1 for ts in log.times.values() for t in ts if inside(t))
    ttft = [ts[0] - log.submit[rid] for rid, ts in log.times.items() if inside(ts[0])]
    itl = [b - a for ts in log.times.values() for a, b in zip(ts, ts[1:]) if inside(b)]
    submitted = [rid for rid, t in log.submit.items() if inside(t)]
    waiting = {r.rid for r in pending}
    lost = [rid for rid in submitted
            if rid not in log.done_at and rid not in active and rid not in waiting]
    record = {
        "kind": "serve", "cfg": cfg, "window_s": t_close - t_open, "trace": summary,
        "prefills": [(n, a) for t, n, a in prefills if inside(t)],
        "steps": [(rows, adps, pos) for t, rows, adps, pos in steps if inside(t)],
        "ttft_s": ttft, "itl_s": itl,
        "stats": {k: stats1[k] - stats0[k] for k in stats0}}
    t_ref = time.perf_counter()
    checks = check(ctx, s, cfg, backbone, tenant_adapters, names, requests, log, t_open, t_close)
    print(f"fedbench: set-up {t_open - ctx.t_start:.1f} s, window {t_close - t_open:.1f} s, "
          f"{len(prefills)} prefills and {len(steps)} steps in all, peak {peak / 2**30:.2f} GiB, "
          f"reference {time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    return {
        "end_to_end": dict(latencies(ttft, itl), serve_tokens_per_s=n_tokens / (t_close - t_open),
                           setup_s=t_open - ctx.t_start),
        "record": record, "checks": checks, "attempted": len(submitted), "failed": len(lost),
        "memory_peak_bytes": peak}


def tail_mean(values, share: float = 0.1) -> float:
    """The mean of the largest ``share`` of ``values`` (at least one): a
    tail that moves with every request in it, where a percentile of
    latencies that come in whole prefills steps from one to the next."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    return float(v[-max(1, int(round(share * len(v)))):].mean())


def latencies(ttft: List[float], itl: List[float]) -> Dict[str, float]:
    """The window's latencies in ms, under the names ``BENCHMARK.json`` may
    give a serving cell's end-to-end metrics: time to first token and the
    gaps between tokens, each as its 95th percentile (for a cell below
    capacity) and as the mean of its slowest tenth."""
    out = {}
    for name, v in (("ttft", ttft), ("itl", itl)):
        if v:
            out[f"{name}_p95_ms"] = 1e3 * float(np.percentile(v, 95))
            out[f"{name}_tail10_mean_ms"] = 1e3 * tail_mean(v)
    return out


def check(ctx, s, cfg, backbone, tenant_adapters, names, requests, log, t_open, t_close):
    """The widest gap of the served tokens of a sample of the requests that
    finished in the window: the one with the most positions, then others
    drawn from the seed until ``reference_tokens`` served tokens."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mix, dev = ctx.cell.traffic, ctx.device
    fin = sorted(rid for rid, t in log.done_at.items() if t_open < t <= t_close)
    served = {rid: len(log.tokens[rid]) for rid in fin}
    longest = max(fin, key=lambda rid: len(requests[rid].prompt) + served[rid])
    rng = np.random.RandomState(sub_seed(ctx.seed, "sample") % 2**32)
    sample, total = [longest], served[longest]
    for rid in rng.permutation([r for r in fin if r != longest]):
        if total >= mix["reference_tokens"] or len(sample) >= mix["reference_max_requests"]:
            break
        sample.append(int(rid))
        total += served[rid]
    by_name = dict(zip(names, tenant_adapters))
    reqs = [{"prompt": torch.from_numpy(np.asarray(requests[rid].prompt, np.int64)).to(dev),
             "served": torch.tensor(log.tokens[rid], dtype=torch.long, device=dev),
             "adapter": by_name.get(requests[rid].tenant)} for rid in sample]
    scale = cfg["nano_adapter"]["alpha"] / cfg["nano_adapter"]["rank"]
    control = Prec(fp8=True) if ctx.control else None
    gap = ref_serve.widest_gap(s, cfg, backbone, reqs, scale, control)
    return harness.judge({"gap": gap}, ctx.cell.limits)
