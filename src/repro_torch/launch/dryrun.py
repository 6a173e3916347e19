"""Dry-run of the launch layer on the H100 (counterpart of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mode fit --arch all --shape all --layout 1x1
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mode roofline --arch h2o-danube-1.8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --run --arch mamba2-130m --shape prefill_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --list

``--all`` takes every assigned arch, as ``--arch all`` (the JAX flag).

``--mode fit`` (the counterpart of ``run_pair``) prints each pair's
analytic per-card footprint on the layout (sharded backbone, adapters,
AdamW state, inputs or decode state, and an allowance of four live
(B, S, D) f32 buffers) and its verdict against the card's 80 GiB. The
estimate is the JAX package's, whose workspace allowance assumes a TPU
step with remat. The port checkpoints each layer too (``cfg.remat``), but
its measured peak (``--run``) at train and prefill shapes is still far
above the allowance: a train step keeps each layer's input through the
backward, and on top of them holds either the f32 logits and their
gradient (at the loss) or one layer's backward (its recomputed
activations and, for attention, the plain flash backward's f32 (B, H, S, S)
scores); ``--run`` prints the first two (``train_transients``) beside the
peak.
``--mode roofline`` (``run_roofline``) counts the step's FLOPs and bytes on
``meta`` tensors through the plain path at reduced depths
(``steps._depth_points``) and extrapolates to full depth, as the JAX
package does with its unrolled compiles; ``roofline.py`` says what the
count is. Both allocate nothing and run on the CPU. ``--out DIR`` writes
each pair's record under the JAX package's file names.

``--run`` runs the step on ``--device`` (default ``cuda``, which raises
without a card): at the shape's global batch, or the largest batch the
card holds (two probe steps at batch 1 and 2 give the peak memory per row),
with the kernels (``use_pallas``) and the "full" execution config; one
warm-up step, then three timed by CUDA events. It prints the cut, the
measured peak (``torch.cuda.max_memory_allocated``) beside the analytic
footprint at that batch, and the measured ms beside the roofline's
max(t_compute, t_memory) at that batch. ``long_500k`` is skipped where
``steps.shape_supported`` says so, with its reason.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import torch

from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, InputShape, get_config
from repro_torch.core.types import Batch
from repro_torch.launch import roofline as roofline_lib
from repro_torch.launch import sharding_rules as rules
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import HBM_BYTES, LAYOUTS, layout, layout_chips
from repro_torch.launch.steps import _depth_points, exec_config, shape_supported
from repro_torch.models import model as model_lib
from repro_torch.models.layers import torch_dtype
from repro_torch.models.vision_stub import num_patches
from repro_torch.optim import adamw_init

# the share of the card's memory a batch is sized to (the allocator's
# fragmentation and the probes' linear model take the rest: at 0.85 of an H100
# 80GB, h2o-danube's prefill_32k sized to 24 rows fitted a fresh process but not
# one whose cache earlier work had fragmented)
FIT_SHARE = 0.8


def analytic_footprint(cfg, shape_cfg, lay) -> dict:
    """Per-card bytes on layout ``lay`` (``dryrun.py:95-128``): sharded
    backbone, replicated adapters (and AdamW state when training), the
    sharded batch or decode state (prefill: the state it returns), and a
    workspace allowance of 4 live (B_loc, S, D) f32 buffers."""
    backbone = steps_lib.backbone_specs(cfg)
    adapters = steps_lib.adapter_specs(cfg)
    out = {"params": rules.sharded_bytes(
               backbone, rules.param_specs(lay, backbone, kind=shape_cfg.kind), lay),
           "adapters": rules.sharded_bytes(adapters, rules.replicated(adapters), lay)}
    ins = steps_lib.input_specs(cfg, shape_cfg)
    if shape_cfg.kind == "train":
        opt = steps_lib.opt_state_specs(cfg)
        out["opt"] = rules.sharded_bytes(opt, rules.replicated(opt), lay)
        out["inputs"] = rules.sharded_bytes(ins["batch"], rules.batch_specs(lay, ins["batch"]),
                                            lay)
    elif shape_cfg.kind == "prefill":
        out["inputs"] = rules.sharded_bytes(ins["batch"], rules.batch_specs(lay, ins["batch"]),
                                            lay)
        state = model_lib.init_state(cfg, shape_cfg.global_batch, shape_cfg.seq_len,
                                     torch_dtype(cfg.dtype), steps_lib.META)
        out["state_out"] = rules.sharded_bytes(state, rules.state_specs(lay, state), lay)
    else:
        out["state"] = rules.sharded_bytes(ins["state"], rules.state_specs(lay, ins["state"]),
                                           lay)
    n_batch_shards = lay.get("pod", 1) * lay.get("data", 1)
    b_loc = max(shape_cfg.global_batch // n_batch_shards, 1)
    s = shape_cfg.seq_len if shape_cfg.kind != "decode" else 1
    out["workspace_est"] = 4 * b_loc * s * cfg.d_model * 4
    out["total"] = sum(out.values())
    return out


def _gib(n) -> str:
    return f"{n / 2**30:.2f} GiB"


# ---------------------------------------------------------------------------
# roofline: counts on meta tensors
# ---------------------------------------------------------------------------

def count_pair(cfg, shape_cfg) -> dict:
    """{"flops", "bytes", "ops"} of one step of ``shape_cfg`` on ``cfg``,
    counted on meta tensors through the plain path."""
    cfg = cfg.with_(use_pallas=False)
    backbone = steps_lib.backbone_specs(cfg)
    adapters = steps_lib.adapter_specs(cfg)
    ins = steps_lib.input_specs(cfg, shape_cfg)
    if shape_cfg.kind == "train":
        return roofline_lib.count_step(steps_lib.make_train_step(cfg), backbone, adapters,
                                       steps_lib.opt_state_specs(cfg), ins["batch"])
    if shape_cfg.kind == "prefill":
        return roofline_lib.count_step(steps_lib.make_prefill_step(cfg, shape_cfg.seq_len),
                                       backbone, adapters, ins["batch"])
    return roofline_lib.count_step(steps_lib.make_decode_step(cfg), backbone, adapters,
                                   ins["state"], ins["token"], ins["pos"])


def extrapolate(kind: str, depths, points, cfg0) -> dict:
    """Full-depth counts from the counts at ``depths`` (``dryrun.py:199-212``):
    exact, linear in depth, or for the hybrid stack f(3) = f0 + t,
    f(6) = f0 + 2t, f(8) = f(6) + 2r -> f0 + n_triples·t + n_extra·r."""
    keys = ("flops", "bytes")
    if kind == "exact":
        return {k: points[0][k] for k in keys}
    if kind == "hybrid":
        n_t, n_e = cfg0.n_layers // 3, cfg0.n_layers % 3
        est = {}
        for k in keys:
            t = points[1][k] - points[0][k]
            r = (points[2][k] - points[1][k]) / 2.0
            est[k] = points[0][k] - t + n_t * t + n_e * r
        return est
    return {k: points[0][k] + (points[1][k] - points[0][k]) / (depths[1] - depths[0])
            * (cfg0.n_layers - depths[0]) for k in keys}


def roofline_counts(cfg0, shape_cfg, overrides=None) -> tuple[dict, str, list, list]:
    """(full-depth {"flops", "bytes"}, extrapolation kind, depths, per-depth counts)."""
    kind, depths = _depth_points(cfg0)
    points = [count_pair(exec_config(cfg0.with_(n_layers=d), shape_cfg, "roofline", overrides),
                         shape_cfg) for d in depths]
    return extrapolate(kind, depths, points, cfg0), kind, depths, points


def roofline_report(arch, cfg0, shape_cfg, layout_name, overrides=None):
    """(RooflineReport, depth-point record) of a pair on a layout."""
    est, kind, depths, points = roofline_counts(cfg0, shape_cfg, overrides)
    rep = roofline_lib.analyze(
        arch=arch, shape=shape_cfg.name, mesh_name=layout_name,
        chips=layout_chips(layout(layout_name)),
        cost={"flops": est["flops"], "bytes accessed": est["bytes"]},
        model_flops=roofline_lib.model_flops_estimate(cfg0, shape_cfg),
        notes="counted on meta tensors through the plain path; no collective term")
    return rep, {"kind": kind, "depths": depths, "points": points}


def run_roofline(arch: str, shape_name: str, layout_name: str = "1x1",
                 overrides: dict | None = None, out_dir: str | None = None,
                 verbose: bool = True, tag: str = "") -> dict:
    """Roofline terms of a pair (``dryrun.py:172-245``)."""
    cfg0 = get_config(arch).with_(**_config_overrides(overrides))
    shape_cfg = INPUT_SHAPES[shape_name]
    ok, why = shape_supported(cfg0, shape_cfg)
    rec = {"arch": arch, "shape": shape_name, "mesh": layout_name, "mode": "roofline",
           "tag": tag, "status": "skip", "reason": why, "overrides": overrides or {}}
    if not ok:
        if verbose:
            print(f"[skip] roofline {arch} x {shape_name}: {why}")
        _maybe_write(out_dir, rec, tag)
        return rec
    t0 = time.time()
    try:
        rep, depth_points = roofline_report(arch, cfg0, shape_cfg, layout_name,
                                            _exec_overrides(overrides))
        rec.update(rep.to_dict())
        rec["status"] = "ok"
        rec["depth_points"] = depth_points
        rec["wall_s"] = round(time.time() - t0, 1)
        if verbose:
            print(f"[roofline] {arch} x {shape_name} on {layout_name} ({depth_points['kind']} @ "
                  f"{depth_points['depths']}, {rec['wall_s']}s{' ' + tag if tag else ''})")
            print(f"     flops={rep.hlo_flops:.3e} bytes={rep.hlo_bytes:.3e} (per card)")
            print(f"     compute {rep.t_compute * 1e3:.2f}ms | memory {rep.t_memory * 1e3:.2f}ms "
                  f"-> {rep.bottleneck}-bound; useful {100 * rep.useful_ratio:.0f}%")
    except Exception as e:  # a pair's failure is recorded; the sweep goes on
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        if verbose:
            print(f"[ERROR] roofline {arch} x {shape_name}: {rec['error']}")
    _maybe_write(out_dir, rec, tag)
    return rec


def run_fit(arch: str, shape_name: str, layout_name: str = "1x1", out_dir: str | None = None,
            verbose: bool = True, overrides: dict | None = None) -> dict:
    """The per-card footprint of a pair on a layout and its verdict against
    the card's memory (the counterpart of ``run_pair``, whose compile proves
    the fit on a TPU mesh; the port has no compiler, so the analytic count
    is the verdict)."""
    cfg = get_config(arch).with_(**_config_overrides(overrides))
    shape_cfg = INPUT_SHAPES[shape_name]
    ok, why = shape_supported(cfg, shape_cfg)
    rec = {"arch": arch, "shape": shape_name, "mesh": layout_name, "mode": "full",
           "status": "skip", "reason": why}
    if not ok:
        if verbose:
            print(f"[skip] {arch} x {shape_name}: {why}")
        _maybe_write(out_dir, rec)
        return rec
    cfg = exec_config(cfg, shape_cfg, "full", _exec_overrides(overrides))
    lay = layout(layout_name)
    foot = analytic_footprint(cfg, shape_cfg, lay)
    rec.update(status="ok", chips=layout_chips(lay), analytic_footprint=foot,
               card_bytes=HBM_BYTES, fits=foot["total"] <= HBM_BYTES)
    if verbose:
        parts = {k: round(v / 2**30, 3) for k, v in foot.items() if k != "total"}
        print(f"[fit] {arch} x {shape_name} x {layout_name}: {_gib(foot['total'])} a card, "
              f"{fit_verdict(rec)} ({parts} GiB)")
    _maybe_write(out_dir, rec)
    return rec


def fit_verdict(rec) -> str:
    """A fit record's verdict, labelled as the analytic estimate it is."""
    verdict = "fits 80 GiB" if rec["fits"] else "over 80 GiB"
    note = ("; --run measures the step's peak"
            if rec["shape"] in INPUT_SHAPES and INPUT_SHAPES[rec["shape"]].kind == "train" else "")
    return f"analytic (TPU remat allowance): {verdict}{note}"


def train_transients(cfg, shape_cfg, batch: int) -> dict:
    """Bytes a train step holds that the analytic allowance of four (B, S, D)
    f32 buffers leaves out, at ``batch`` rows, from the config alone:
    ``layer_inputs``, each layer body's input that ``cfg.remat`` keeps
    through the backward (0 without remat, which keeps every activation
    instead); ``logits``, the f32 logits and their gradient, held at the
    loss only (0 under ``loss_chunk``, whose chunks die inside). The two do
    not add up to a peak: a layer's backward, which these leave out, frees
    the logits first."""
    s = shape_cfg.seq_len
    bodies = cfg.n_layers // 3 + cfg.n_layers % 3 if cfg.family == "hybrid" else cfg.n_layers
    positions = bodies * s + cfg.n_enc_layers * cfg.enc_seq_len  # whisper's encoder: its frames
    itemsize = torch_dtype(cfg.dtype).itemsize
    return {"layer_inputs": positions * batch * cfg.d_model * itemsize if cfg.remat else 0,
            "logits": 0 if cfg.loss_chunk else 2 * batch * s * cfg.vocab_size * 4}


# ---------------------------------------------------------------------------
# --run: the step on the device
# ---------------------------------------------------------------------------

def make_inputs(cfg, shape_cfg, batch: int, device, seed: int = 0) -> dict:
    """Real inputs of a workload at ``batch`` rows, drawn from ``seed`` on
    ``device`` (keys as ``steps.input_specs``): random tokens, labels, a
    mask of about 70 % ones and stub patches; a decode state of zeros at
    position seq_len - 1."""
    gen = torch.Generator(device=device).manual_seed(seed)
    s = shape_cfg.seq_len
    if shape_cfg.kind == "decode":
        return {"state": model_lib.init_state(cfg, batch, s, torch_dtype(cfg.dtype), device),
                "token": torch.randint(0, cfg.vocab_size, (batch,), generator=gen,
                                       device=device, dtype=torch.int32),
                "pos": torch.full((), s - 1, dtype=torch.int32, device=device)}
    s_text = steps_lib.text_seq_len(cfg, s)
    tokens, labels = (torch.randint(0, cfg.vocab_size, (batch, s_text), generator=gen,
                                    device=device, dtype=torch.int32) for _ in range(2))
    mask = (torch.rand((batch, s_text), generator=gen, device=device) < 0.7).float()
    patches = None
    if cfg.frontend_dim:
        patches = torch.randn((batch, num_patches(cfg), cfg.frontend_dim), generator=gen,
                              device=device).to(torch_dtype(cfg.dtype))
    return {"batch": Batch(tokens=tokens, labels=labels, mask=mask, patches=patches)}


def step_runner(cfg, shape_cfg, backbone, adapters):
    """``fn(inputs) -> outputs``: the workload's step on its inputs."""
    if shape_cfg.kind == "train":
        step, opt = steps_lib.make_train_step(cfg), adamw_init(adapters)
        return lambda ins: step(backbone, adapters, opt, ins["batch"])
    if shape_cfg.kind == "prefill":
        step = steps_lib.make_prefill_step(cfg, shape_cfg.seq_len)
        return lambda ins: step(backbone, adapters, ins["batch"])
    step = steps_lib.make_decode_step(cfg)
    return lambda ins: step(backbone, adapters, ins["state"], ins["token"], ins["pos"])


def _peak_at(cfg, shape_cfg, run, batch: int, device) -> int:
    ins = make_inputs(cfg, shape_cfg, batch, device)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run(ins)
    torch.cuda.synchronize()
    del ins
    return torch.cuda.max_memory_allocated()


def fit_batch(cfg, shape_cfg, run, device) -> tuple[int, dict]:
    """The largest batch up to the shape's global batch that the card holds
    in FIT_SHARE of its memory, from the measured peaks of one step at batch
    1 and 2 (peak = base + rows · per_row). -> (batch, the probe record)."""
    p1 = _peak_at(cfg, shape_cfg, run, 1, device)
    p2 = _peak_at(cfg, shape_cfg, run, 2, device)
    per_row = max(p2 - p1, 1)
    cap = FIT_SHARE * torch.cuda.get_device_properties(device).total_memory
    fits = int((cap - (p1 - per_row)) // per_row)
    batch = max(1, min(shape_cfg.global_batch, fits))
    return batch, {"peak_b1": p1, "peak_b2": p2, "per_row": per_row, "fits": fits}


def time_step(run, ins, device, iters: int = 3) -> list:
    """Per-step ms: CUDA events around each of ``iters`` steps after one
    warm-up step on the same inputs (the allocator grows to the batch
    there); on the CPU the host clock."""
    cuda = torch.device(device).type == "cuda"
    run(ins)
    times = []
    for _ in range(iters):
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run(ins)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            run(ins)
            times.append(1e3 * (time.perf_counter() - t0))
    return times


def run_on_device(arch: str, shape_name: str, overrides: dict | None = None,
                  device="cuda", seed: int = 0, verbose: bool = True) -> dict:
    """``--run``: the step at the shape's global batch or the largest batch the
    card holds, kernels on; ms, peak memory, footprint and roofline at that
    batch. On the CPU (``device="cpu"``, only when asked) the global batch
    and the host clock, the kernels' plain versions, no peak."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun --run needs a CUDA card (or --device cpu)")
    cfg0 = get_config(arch).with_(**_config_overrides(overrides))
    shape_cfg = INPUT_SHAPES[shape_name]
    ok, why = shape_supported(cfg0, shape_cfg)
    rec = {"arch": arch, "shape": shape_name, "mode": "run", "status": "skip", "reason": why,
           "device": str(dev)}
    if not ok:
        if verbose:
            print(f"[skip] run {arch} x {shape_name}: {why}")
        return rec
    cfg = exec_config(cfg0, shape_cfg, "full", _exec_overrides(overrides)).with_(use_pallas=True)
    backbone = model_lib.init_backbone(cfg, seed=seed, device=dev)
    adapters = steps_lib.adapter_specs(cfg, dev)
    run = step_runner(cfg, shape_cfg, backbone, adapters)
    batch, probe = shape_cfg.global_batch, None
    if dev.type == "cuda" and batch > 2:
        batch, probe = fit_batch(cfg, shape_cfg, run, dev)
    rec.update(run_record(arch, cfg0, cfg, shape_cfg, run, batch, dev, probe))
    if verbose:
        print(run_line(rec))
    return rec


def run_record(arch, cfg0, cfg, shape_cfg, run, batch, device, probe, iters=3,
               rep=None) -> dict:
    """Times ``run`` at ``batch`` rows and sets its numbers beside the
    analytic footprint and the roofline at that batch (``rep``, where the
    caller has counted it)."""
    dev = torch.device(device)
    shape_b = InputShape(shape_cfg.name, shape_cfg.kind, shape_cfg.seq_len, batch)
    ins = make_inputs(cfg, shape_cfg, batch, dev)
    if dev.type == "cuda":  # cached blocks of earlier work released, so the batch's fit holds
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    ms = time_step(run, ins, dev, iters)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
    if rep is None:
        rep, _ = roofline_report(arch, cfg0, shape_b, "1x1")
    bound = max(rep.t_compute, rep.t_memory)
    return {"status": "ok", "batch": batch, "global_batch": shape_cfg.global_batch,
            "probe": probe, "ms": ms, "peak_bytes": peak, "remat": cfg.remat,
            "footprint": analytic_footprint(cfg, shape_b, layout("1x1"))["total"],
            "transients": (train_transients(cfg, shape_cfg, batch)
                           if shape_cfg.kind == "train" else None),
            "t_compute": rep.t_compute, "t_memory": rep.t_memory,
            "bottleneck": rep.bottleneck,
            "ms_over_bound": (sum(ms) / len(ms)) / (1e3 * bound) if peak is not None else None}


def run_line(rec) -> str:
    cut = ("the global batch" if rec["batch"] == rec["global_batch"]
           else f"cut from {rec['global_batch']} to the largest batch the card holds")
    peak = "not measured (CPU)" if rec["peak_bytes"] is None else _gib(rec["peak_bytes"])
    tr = rec.get("transients")
    held = "" if tr is None else (
        f" (remat {'on' if rec['remat'] else 'off'}; beyond the analytic allowance the step "
        "keeps " + (f"each layer's input ({_gib(tr['layer_inputs'])})" if rec["remat"]
                    else "every layer's activations")
        + f" through the backward and on top of them holds either f32 logits and their "
        f"gradient ({_gib(tr['logits'])}) or one layer's backward, not measured apart here)")
    return (f"[run] {rec['arch']} x {rec['shape']} on {rec['device']}: batch {rec['batch']} "
            f"({cut}); ms {', '.join(f'{t:.3f}' for t in rec['ms'])}; peak {peak} against "
            f"the analytic {_gib(rec['footprint'])}{held}; roofline compute "
            f"{rec['t_compute'] * 1e3:.3f} ms, memory {rec['t_memory'] * 1e3:.3f} ms "
            f"({rec['bottleneck']}-bound), measured / max "
            + ("not measured (CPU)" if rec["ms_over_bound"] is None
               else f"{rec['ms_over_bound']:.2f}"))


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _config_overrides(overrides):
    """The overrides applied to the full config before anything else (all
    but ``attn_chunk``, which ``exec_config`` sets per mode), so that an
    ``n_layers`` override is the full depth the roofline extrapolates to."""
    steps_lib.check_overrides(overrides)
    return {k: v for k, v in (overrides or {}).items() if k != "attn_chunk"}


def _exec_overrides(overrides):
    return {k: v for k, v in (overrides or {}).items() if k == "attn_chunk"} or None


def _maybe_write(out_dir, rec, tag: str = ""):
    if not out_dir:
        return
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    name = (f"{rec['arch']}__{rec['shape']}__{rec['mesh']}__{rec.get('mode', 'full')}"
            f"{suffix}.json").replace("/", "_")
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(rec, f, indent=1, default=str)


def parse_overrides(items) -> dict:
    overrides = {}
    for ov in items:
        k, v = ov.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v
    get_config(ASSIGNED_ARCHS[0]).with_(**_config_overrides(overrides))  # unknown fields raise
    return overrides


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=ASSIGNED_ARCHS + ["all"], default="all")
    ap.add_argument("--shape", choices=list(INPUT_SHAPES) + ["all"], default="all")
    ap.add_argument("--layout", choices=list(LAYOUTS), default="1x1")
    ap.add_argument("--mode", choices=["fit", "roofline", "both"], default="fit")
    ap.add_argument("--override", action="append", default=[],
                    help="config override key=value (e.g. loss_chunk=1024)")
    ap.add_argument("--out", default=None, help="directory for per-pair JSON records")
    ap.add_argument("--tag", default="", help="suffix of the roofline records' file names")
    ap.add_argument("--all", action="store_true",
                    help="every assigned arch (x --shape, default all), as --arch all")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--run", action="store_true",
                    help="run each step once on --device and time it, instead of --mode")
    ap.add_argument("--device", default="cuda", help="device of --run (default cuda)")
    args = ap.parse_args(argv)

    if args.list:
        for a in ASSIGNED_ARCHS:
            print(a)
        return 0
    overrides = parse_overrides(args.override)
    archs = ASSIGNED_ARCHS if (args.all or args.arch == "all") else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    n_err = 0
    for arch in archs:
        for shape in shapes:
            if args.run:
                run_on_device(arch, shape, overrides or None, device=args.device)
                continue
            if args.mode in ("fit", "both"):
                run_fit(arch, shape, args.layout, args.out, overrides=overrides or None)
            if args.mode in ("roofline", "both"):
                rec = run_roofline(arch, shape, args.layout, overrides or None, args.out,
                                   tag=args.tag)
                n_err += rec["status"] == "error"
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
