"""Generator of the federated-round mixes: FedNano rounds of one of the
port's engines over clients that hold Dirichlet non-IID shards of a
synthetic VQA corpus.

The run is one ``run_federated`` call, as a user's run is: its first
``warmup_rounds`` rounds are set-up (round 0 builds and loads every kernel),
and the window is the whole rounds after them, until the first round end at
least ``seconds`` after the window opened; later rounds select no client and
do nothing. The rounds are delimited by the client sampler, a hook of the
program's API, which waits for the card at each round start and picks the
round's cohort: every client, or a share of them drawn from the seed. A
FedNano strategy that records what the program computed in round 0 and in
the window's last round, and otherwise is the program's FedNano, lets the
reference judge both.

Mix keys: ``clients``, ``rows`` (a batch's rows), ``text_tokens``,
``question_tokens`` ([min, max) of a question's length), ``examples_per_client``,
``dirichlet_alpha``, ``local_steps``, ``fisher_batches``, ``lr``,
``grad_clip``, ``warmup_rounds``, ``max_window_rounds``, ``reference_clients``
(how many of round 0's clients the reference follows through the whole
round); optional: ``engine`` (``run_federated``'s, default ``vmap``),
``agg_chunk`` (its streaming merge and cohort chunk, default none) and
``participation`` (the share of the clients in each round, default 1).
"""
from __future__ import annotations

import statistics
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from fedbench import families, harness
from fedbench.reference import train as ref_train
from fedbench.reference.precision import Prec
from fedbench.traffic.synthetic import SyntheticVQA, client_batches, dirichlet_partition
from fedbench.weights import draw_adapters, draw_backbone, sub_seed


def make_data(cfg: dict, mix: dict, seed: int) -> List[List[Dict[str, np.ndarray]]]:
    """Each client's batches (numpy), client by client."""
    stub = cfg.get("frontend_stub") or {}
    gen = SyntheticVQA(vocab_size=cfg["vocab_size"], seq_len=mix["text_tokens"],
                       frontend_dim=stub.get("width", 0), n_patches=stub.get("patches", 0),
                       question_tokens=tuple(mix["question_tokens"]))
    k, rows = mix["clients"], mix["rows"]
    examples = gen.generate(k * mix["examples_per_client"], seed=sub_seed(seed, "data") % 2**32)
    shards = dirichlet_partition(examples, [e.topic for e in examples], k,
                                 mix["dirichlet_alpha"], seed=sub_seed(seed, "shards") % 2**32,
                                 min_per_client=max(2 * rows, 8))
    return [client_batches(shards[c], rows) for c in range(k)]


def required_rows(batch: Dict[str, np.ndarray], patches: int):
    """(required positions, supervised positions) of each row: up to its
    last supervised position, the image prefix included."""
    out = []
    for m in batch["mask"]:
        sup = np.nonzero(m)[0]
        out.append((patches + int(sup.max()) + 1 if len(sup) else 0, int(len(sup))))
    return out


class RoundRecord:
    """What the program computed in one round: every training step's loss in
    the order the engine ran them, the downloaded global adapters, each
    upload (with the AdamW moments where ``full``) and the merge."""

    def __init__(self, r: int, cohort: List[int], full: bool):
        self.round, self.cohort, self.full = r, list(cohort), full
        self.losses: List[torch.Tensor] = []
        self.download = None
        self.uploads: Dict[int, dict] = {}
        self.merged = None


class Recorder:
    """Round 0's record (``first``) and the latest round's after it
    (``last``: at the window's close, the window's last round). ``current``
    is the round that runs, None in a round that selects no client."""

    def __init__(self):
        self.first: Optional[RoundRecord] = None
        self.last: Optional[RoundRecord] = None
        self.current: Optional[RoundRecord] = None

    def begin(self, r: int, cohort: List[int]) -> None:
        self.current = RoundRecord(r, cohort, full=r == 0)
        if r == 0:
            self.first = self.current
        else:
            self.last = self.current


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone()


def recording_fednano(recorder: Recorder):
    from repro_torch.strategies.builtin import FedNano

    @dataclass(frozen=True)
    class RecordingFedNano(FedNano):
        """The program's FedNano; it keeps copies of what the round computes
        in ``recorder.current``."""

        def wrap_local_loss(self, loss_fn, hp, global_ref):
            inner = super().wrap_local_loss(loss_fn, hp, global_ref)
            rec = recorder.current
            if rec is None:
                return inner

            def wrapped(adp):
                loss, aux = inner(adp)
                rec.losses.append(loss.detach())
                return loss, aux

            return wrapped

        def post_local_update(self, state, global_adapters, round_idx):
            rec = recorder.current
            if rec is not None:
                if rec.download is None:
                    rec.download = _clone(global_adapters)
                up = {"theta": _clone(state.adapters), "fisher": _clone(state.fisher),
                      "n": state.n_examples}
                if rec.full:
                    up.update(mu=_clone(state.opt_state.mu), nu=_clone(state.opt_state.nu))
                rec.uploads[state.cid] = up
            return super().post_local_update(state, global_adapters, round_idx)

        def aggregate(self, thetas, fishers, data_sizes, *, use_pallas=False):
            merged = super().aggregate(thetas, fishers, data_sizes, use_pallas=use_pallas)
            if recorder.current is not None:
                recorder.current.merged = _clone(merged)
            return merged

        def agg_stream_finalize(self, acc, **kw):
            merged = super().agg_stream_finalize(acc, **kw)
            if recorder.current is not None and merged is not None:
                recorder.current.merged = _clone(merged)
            return merged

    return RecordingFedNano()


class Clock:
    """Round starts -> set-up, window, or nothing; the window's bounds and
    the cohort of each of its rounds."""

    def __init__(self, warmup: int, seconds: float, device: str, recorder: Recorder, tracer,
                 cohort_of):
        self.warmup, self.seconds, self.device = warmup, seconds, device
        self.recorder, self.tracer, self.cohort_of = recorder, tracer, cohort_of
        self.t_open = self.t_close = None
        self.round_ends: List[float] = []
        self.cohorts: List[List[int]] = []        # the window's rounds'

    def _now(self) -> float:
        if self.device.startswith("cuda"):
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def _begin(self, r: int, cids) -> List[int]:
        cohort = self.cohort_of(r, list(cids))
        self.recorder.begin(r, cohort)
        if r >= self.warmup:
            self.cohorts.append(cohort)
        return cohort

    def select(self, r: int, cids):
        if r < self.warmup:
            return self._begin(r, cids)
        if self.t_close is not None:
            return []
        if r == self.warmup:
            if self.tracer is not None:
                self.tracer.start()
            self.t_open = self._now()
            if self.tracer is not None:
                self.tracer.mark("fedbench.open")
            return self._begin(r, cids)
        now = self._now()
        self.round_ends.append(now)
        if now - self.t_open >= self.seconds:
            self.t_close = now
            self.recorder.current = None
            if self.tracer is not None:
                self.tracer.mark("fedbench.close")
                self.tracer.stop()
            return []
        return self._begin(r, cids)


def chunk_width(engine: str, agg_chunk: Optional[int], n: int) -> int:
    """How many clients the engine runs together, step by step: the loss
    records of a round come chunk by chunk, each step by step."""
    if engine == "vmap":
        return agg_chunk or n
    if engine == "sequential":
        return 1
    raise NotImplementedError(f"the federated generator reads no losses of engine {engine!r}")


def step_losses(rec: RoundRecord, steps: int, width: int) -> Dict[int, np.ndarray]:
    """Each client's (steps,) losses of a recorded round."""
    flat = torch.stack(rec.losses).float().cpu().numpy().reshape(-1)
    if len(flat) != steps * len(rec.cohort):
        raise RuntimeError(f"round {rec.round}: {len(flat)} losses recorded for "
                           f"{len(rec.cohort)} clients of {steps} steps")
    out, at = {}, 0
    for i in range(0, len(rec.cohort), width):
        chunk = rec.cohort[i:i + width]
        block = flat[at:at + steps * len(chunk)].reshape(steps, len(chunk))
        out.update({c: block[:, j] for j, c in enumerate(chunk)})
        at += steps * len(chunk)
    return out


def run(ctx: harness.Ctx) -> dict:
    from repro_torch.core.client import HyperParams
    from repro_torch.core.federated import run_federated
    from repro_torch.core.server import ServerState
    from repro_torch.core.types import Batch
    from repro_torch.strategies.sampling import ClientSampler

    cell, mix, cfg, dev = ctx.cell, ctx.cell.traffic, ctx.cell.cfg, ctx.device
    fam = families.load(cfg)
    s = fam.shape_of(cfg)
    pcfg = harness.port_config(cfg, cell.config_name)
    patches = (cfg.get("frontend_stub") or {}).get("patches", 0)
    backbone = draw_backbone(fam.leaves(cfg), ctx.seed, dev, getattr(torch, cfg["torch_dtype"]))
    global0 = draw_adapters(s, cfg["nano_adapter"]["modalities"], 1, ctx.seed, "global", dev)[0]
    data = make_data(cfg, mix, ctx.seed)
    to_batch = lambda b: Batch(
        tokens=torch.from_numpy(b["tokens"]).long().to(dev),
        labels=torch.from_numpy(b["labels"]).long().to(dev),
        mask=torch.from_numpy(b["mask"]).to(dev),
        patches=torch.from_numpy(b["patches"]).to(dev) if "patches" in b else None)
    train_data = {c: [to_batch(b) for b in bl] for c, bl in enumerate(data)}
    hp = HyperParams(lr=mix["lr"], grad_clip=mix["grad_clip"], local_steps=mix["local_steps"],
                     fisher_batches=mix["fisher_batches"])
    k, engine, agg_chunk = mix["clients"], mix.get("engine", "vmap"), mix.get("agg_chunk")
    share = mix.get("participation", 1.0)
    cohort_size = min(k, max(1, int(round(share * k))))

    def cohort_of(r: int, cids: List[int]) -> List[int]:
        if cohort_size >= len(cids):
            return cids
        rng = np.random.RandomState(sub_seed(ctx.seed, f"cohort{r}") % 2**32)
        return sorted(cids[int(i)] for i in rng.choice(len(cids), cohort_size, replace=False))

    recorder = Recorder()
    tracer = None
    if ctx.trace:
        from fedbench.tracing import Tracer
        tracer = Tracer()
    clock = Clock(mix["warmup_rounds"], ctx.seconds, dev, recorder, tracer, cohort_of)

    @dataclass(frozen=True)
    class WindowSampler(ClientSampler):
        def select(self, round_idx, cids):
            return clock.select(round_idx, cids)

    server = ServerState(cfg=pcfg, backbone=backbone, global_adapters=global0)
    result = run_federated(sub_seed(ctx.seed, "clients"), pcfg, train_data, {},
                           strategy=recording_fednano(recorder),
                           rounds=mix["warmup_rounds"] + mix["max_window_rounds"], hp=hp,
                           use_pallas=True, server=server, sampler=WindowSampler(),
                           engine=engine, agg_chunk=agg_chunk, final_eval=False, device=dev)
    if clock.t_close is None:
        raise RuntimeError(f"the window did not close within {mix['max_window_rounds']} rounds")
    peak = torch.cuda.max_memory_allocated(dev) if dev.startswith("cuda") else 0
    cohorts = clock.cohorts
    window_s = clock.t_close - clock.t_open
    round_metrics = result.round_metrics[mix["warmup_rounds"]:
                                         mix["warmup_rounds"] + len(cohorts)]
    failed = sum(len(c) for c, m in zip(cohorts, round_metrics)
                 if m["participants"] != len(c) or not np.isfinite(m["mean_loss"] or np.nan))
    del result, server
    summary = tracer.summary() if tracer is not None else None
    if dev.startswith("cuda"):
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    positions = mix["rows"] * (patches + mix["text_tokens"])
    passes = []
    for cohort in cohorts:
        steps = [[data[c][t % len(data[c])] for c in cohort] for t in range(mix["local_steps"])]
        fish = [[data[c][t] for c in cohort] for t in range(mix["fisher_batches"])]
        passes += [[row for b in bs for row in required_rows(b, patches)] for bs in steps + fish]
    width = lambda rec: chunk_width(engine, agg_chunk, len(rec.cohort))
    checks = check(ctx, s, cfg, backbone, global0, data, recorder, width)
    print(f"fedbench: set-up {clock.t_open - ctx.t_start:.1f} s, window {window_s:.1f} s of "
          f"{len(cohorts)} rounds, peak {peak / 2**30:.2f} GiB, reference "
          f"{time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    round_ends = [clock.t_open] + clock.round_ends
    trained = sum(len(c) for c in cohorts) * mix["local_steps"] * positions
    return {
        "end_to_end": {"train_tokens_per_s": trained / window_s,
                       "setup_s": clock.t_open - ctx.t_start},
        "record": {"kind": "train", "cfg": cfg, "window_s": window_s, "rounds": len(cohorts),
                   "passes": passes, "patches": patches, "trace": summary,
                   "round_s": [b - a for a, b in zip(round_ends, round_ends[1:])]},
        "checks": checks, "attempted": sum(len(c) for c in cohorts), "failed": failed,
        "memory_peak_bytes": peak}


def _norms(tree) -> List[float]:
    return [float(tree[m][n].double().norm()) for m in sorted(tree) for n in sorted(tree[m])]


def norm_gap(prog: List[float], refr: List[float], keep: List[bool]) -> float:
    """The worst leaf's gap of norms, over the larger of the reference's
    norm of that leaf and of the median leaf."""
    med = statistics.median(refr)
    return max((abs(p - r) / max(r, med) for p, r, k in zip(prog, refr, keep) if k),
               default=0.0)


def _sub(a, b):
    return {m: {n: a[m][n].double() - b[m][n].double() for n in a[m]} for m in a}


def merge_gap(rec: RoundRecord) -> float:
    """The program's merge of a round against Eq. 1 in float64 over the
    same uploads: the worst leaf's largest error over its largest entry."""
    cids = sorted(rec.uploads)
    merged = ref_train.fisher_merge([rec.uploads[c]["theta"] for c in cids],
                                    [rec.uploads[c]["fisher"] for c in cids],
                                    [rec.uploads[c]["n"] for c in cids])
    return max(float((rec.merged[m][n].double() - merged[m][n]).abs().max()
                     / merged[m][n].abs().max()) for m in merged for n in merged[m])


def check(ctx, s, cfg, backbone, global0, data, recorder: Recorder, width) -> Dict[str, list]:
    """Round 0 and the window's last round against the reference.

    * ``loss``: every client's first-step loss in round 0 (both sides start
      from the same adapters; the later steps' losses move with AdamW's
      sign-sized steps far more than the forward errs, PERF.md, and are
      printed only);
    * ``moments``, ``update``: the AdamW moments and adapter change after
      round 0's local steps of ``reference_clients`` clients drawn from the
      seed, which the reference follows from the global adapters, each
      leaf's gap of norms;
    * ``fisher``: round 0's Fisher pass by itself, at the program's own final
      adapters (a Fisher at the end of the reference's own steps moves with
      AdamW's sign-sized steps far more than the pass errs; PERF.md);
    * ``merge``: round 0's merge of every client's upload;
    * ``loss_window``, ``merge_window``: the same two of the window's last
      round, the first-step losses from the global adapters that its
      clients downloaded (the program's previous merge, which the reference
      reads only as the round's start). A loss's rounding in bf16 does not
      shrink as training lowers the loss, so its gap is taken over the
      client's loss at round 0's start, the scale ``loss`` is read in
      (PERF.md).

    With ``ctx.control`` the fp8 reference takes the program's place in the
    losses, moments, update and Fisher."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mix, dev = ctx.cell.traffic, ctx.device
    steps = mix["local_steps"]
    scale = cfg["nano_adapter"]["alpha"] / cfg["nano_adapter"]["rank"]
    to_dev = lambda b: {f: torch.from_numpy(v).to(dev).long() if f in ("tokens", "labels")
                        else torch.from_numpy(v).to(dev) for f, v in b.items()}
    hp = {"lr": mix["lr"], "grad_clip": mix["grad_clip"], "local_steps": steps,
          "fisher_batches": mix["fisher_batches"]}
    fp8 = Prec(fp8=True)

    def first_steps(rec: RoundRecord, start) -> Dict[int, tuple]:
        """Each client's (program's, reference's) first-step loss of a round
        that starts from the adapters ``start``."""
        losses = step_losses(rec, steps, width(rec))
        out = {}
        for c in rec.cohort:
            batch = to_dev(data[c][0])
            l1 = ref_train.first_loss(s, cfg, backbone, start, batch, scale)
            lp = (ref_train.first_loss(s, cfg, backbone, start, batch, scale, fp8)
                  if ctx.control else float(losses[c][0]))
            out[c] = (lp, l1)
        return out

    first, last = recorder.first, recorder.last
    r0 = first_steps(first, global0)
    rw = first_steps(last, last.download)
    initial = {c: r0[c][1] if c in r0 else ref_train.first_loss(
        s, cfg, backbone, global0, to_dev(data[c][0]), scale) for c in rw}
    gaps0 = [abs(lp - l1) / abs(l1) for lp, l1 in r0.values()]
    gaps_w = [abs(lp - l1) / abs(initial[c]) for c, (lp, l1) in rw.items()]
    print(f"fedbench: first-step losses (program, reference), round 0 {list(r0.values())}, "
          f"round {last.round} {list(rw.values())}; gaps over the reference's loss, round 0 "
          f"{gaps0}, round {last.round} {[abs(a - b) / abs(b) for a, b in rw.values()]}; "
          f"round {last.round}'s over the round-0 loss {gaps_w}", file=sys.stderr)
    losses0 = step_losses(first, steps, width(first))
    rng = np.random.RandomState(sub_seed(ctx.seed, "sample") % 2**32)
    chosen = rng.choice(len(first.cohort), mix["reference_clients"], replace=False)
    moments = update = fisher = 0.0
    for c in sorted(first.cohort[int(i)] for i in chosen):
        batches = [to_dev(b) for b in data[c]]
        out = ref_train.client_round(s, cfg, backbone, global0, batches, hp, scale)
        if ctx.control:
            prog = ref_train.client_round(s, cfg, backbone, global0, batches, hp, scale, fp8)
            prog["fisher"] = ref_train.fisher_at(s, cfg, backbone, global0, prog["theta"],
                                                 batches, hp, scale, fp8)
        else:
            prog = dict(first.uploads[c], losses=[float(x) for x in losses0[c]])
        ref_fisher = ref_train.fisher_at(s, cfg, backbone, global0, prog["theta"], batches, hp,
                                         scale)
        gmax = _norms(out["grad_max"])
        keep = [g >= 1e-3 * statistics.median(gmax) for g in gmax]
        change = lambda r: _norms(_sub(r["theta"], global0))
        moments = max(moments, norm_gap(_norms(prog["mu"]), _norms(out["mu"]), keep),
                      norm_gap(_norms(prog["nu"]), _norms(out["nu"]), keep))
        update = max(update, norm_gap(change(prog), change(out), keep))
        fisher = max(fisher, norm_gap(_norms(prog["fisher"]), _norms(ref_fisher), keep))
        print(f"fedbench: client {c}, leaves {[f'{m}/{n}' for m in sorted(global0) for n in sorted(global0[m])]}: "
              f"losses {prog['losses']} reference {out['losses']}; AdamW m {_norms(prog['mu'])} "
              f"reference {_norms(out['mu'])}; change {change(prog)} reference {change(out)}; "
              f"Fisher {_norms(prog['fisher'])} reference {_norms(ref_fisher)}", file=sys.stderr)
    numbers = {"loss": max(gaps0), "moments": moments, "update": update, "fisher": fisher,
               "merge": merge_gap(first), "loss_window": max(gaps_w),
               "merge_window": merge_gap(last)}
    return harness.judge(numbers, ctx.cell.limits)
