"""Roofline terms of a step on the H100 (counterpart of ``repro.launch.roofline``).

Two terms per (arch x shape x layout), in seconds, with the card's peaks
from ``repro_torch.launch.mesh``:

    compute = FLOPs per card / 989 TFLOP/s (bf16 dense)
    memory  = bytes per card / 3.35 TB/s

The JAX package reads both counts from ``compiled.cost_analysis()``. The
port has no compiler: :func:`count_step` runs the step once on ``meta``
tensors through the plain path and counts every aten operation it
dispatches (:class:`OpCounter`). FLOPs are those of
``torch.utils.flop_counter``'s formulas (matrix products, convolutions,
attention), so elementwise work counts in bytes only; bytes are each
operation's inputs and outputs, unfused (views move none), an upper bound
of what a fused program moves. A layout of N cards divides both counts by N:
an even split and no collective. The JAX package's third term, collective
bytes parsed from the optimized HLO, has no counterpart: there is no HLO,
and one process runs no collective. The record keeps its fields as None.

Also computed: MODEL_FLOPS = 6·N·D (train) or 2·N·D (inference) with N the
active parameters, and the useful-compute ratio MODEL_FLOPS / FLOPs.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.launch.mesh import HBM_BYTES_PER_S, PEAK_OPS


def _is_view(func) -> bool:
    """Every output aliases an input and none is written: a view moves no byte."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write
                              for r in rets)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _pytree_leaves(tree)
               if isinstance(t, torch.Tensor))


class OpCounter(TorchDispatchMode):
    """Counts FLOPs and bytes of every aten operation dispatched under it:
    ``flops`` by ``torch.utils.flop_counter``'s formulas, ``bytes`` each
    operation's tensor inputs and outputs (a view's none). It runs every
    operation as it is, so on ``meta`` tensors nothing is allocated."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        if not _is_view(func):
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


def count_step(step, *args) -> Dict[str, float]:
    """{"flops", "bytes", "ops"} of one call of ``step(*args)``; the args are
    meta tensors, so nothing runs on a device and nothing is allocated."""
    leaves = [t for t in _pytree_leaves(args) if isinstance(t, torch.Tensor)]
    if any(t.device.type != "meta" for t in leaves):
        raise ValueError("count_step counts a step on meta tensors only")
    with OpCounter() as counter:
        step(*args)
    return {"flops": float(counter.flops), "bytes": float(counter.bytes),
            "ops": float(counter.ops)}


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float           # counted FLOPs per card (the port has no HLO; the JAX name kept)
    hlo_bytes: float           # counted bytes per card
    collective_bytes: Optional[float]
    collective_breakdown: Optional[Dict[str, int]]
    t_compute: float
    t_memory: float
    t_collective: Optional[float]
    bottleneck: str
    model_flops: float
    useful_ratio: float
    bytes_per_device: Optional[float] = None
    notes: str = ""

    def to_dict(self):
        return asdict(self)


def analyze(*, arch: str, shape: str, mesh_name: str, chips: int, cost: Dict,
            model_flops: float, bytes_per_device: Optional[float] = None,
            notes: str = "") -> RooflineReport:
    """Per-card terms from a whole-step ``cost`` {"flops", "bytes accessed"}
    split evenly over ``chips`` cards; the bottleneck is the larger of
    compute and memory (no collective term)."""
    flops = float(cost.get("flops", 0.0)) / max(chips, 1)
    nbytes = float(cost.get("bytes accessed", 0.0)) / max(chips, 1)
    t_c = flops / PEAK_OPS["bf16"]
    t_m = nbytes / HBM_BYTES_PER_S
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips, hlo_flops=flops,
        hlo_bytes=nbytes, collective_bytes=None, collective_breakdown=None,
        t_compute=t_c, t_memory=t_m, t_collective=None,
        bottleneck="compute" if t_c >= t_m else "memory", model_flops=model_flops,
        useful_ratio=(model_flops / max(chips, 1) / flops) if flops else 0.0,
        bytes_per_device=bytes_per_device, notes=notes)


def model_flops_estimate(cfg, shape_cfg) -> float:
    """6·N·D (training) / 2·N·D (inference) with N the active parameters."""
    from repro_torch.core.comm import backbone_param_count

    n = backbone_param_count(cfg)
    if cfg.family == "moe":
        m = cfg.moe
        expert_total = cfg.n_layers * m.n_experts * 3 * cfg.d_model * cfg.d_ff
        expert_active = cfg.n_layers * m.top_k * 3 * cfg.d_model * cfg.d_ff
        n = n - expert_total + expert_active
    tokens = shape_cfg.global_batch * (shape_cfg.seq_len if shape_cfg.kind != "decode" else 1)
    mult = 6.0 if shape_cfg.kind == "train" else 2.0
    return mult * n * tokens
