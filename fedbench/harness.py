"""What every cell shares: finding its configuration, traffic mix, limits
and per-layer readers by name, the port's config, the device, the import
check, and the result line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<config>.json``,
whose ``port`` block names its family: ``families/<family>.py`` and
``reference/<family>.py``) and a traffic mix (``traffic/<mix>.json``). The mix names its generator
(``traffic/<generator>.py``, which exposes ``run(ctx)``); the cell's limits
are ``limits/<cell>.json``; a per-layer metric is ``metrics/<metric>.py``,
whose ``read(record)`` returns its number or None where the record holds
nothing for it.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    cfg: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


@dataclass
class Ctx:
    """What a generator's ``run`` gets."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float                    # perf_counter at the process's start
    control: bool = False             # judge the fp8 control in the program's place


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> Cell:
    bench = load_json(ROOT / "BENCHMARK.json")
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"unknown workload {name!r}; known: "
                         f"{[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    per = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]
    return Cell(name=name, chips=wl["chips"], config_name=conf["name"],
                cfg=load_json(ROOT / conf["file"]), traffic_name=wl["traffic"],
                traffic=load_json(HERE / "traffic" / f"{wl['traffic']}.json"),
                limits=load_json(HERE / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per)


def generator(traffic: dict):
    return importlib.import_module(f"fedbench.traffic.{traffic['generator']}")


def load_reader(metric: str):
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"fedbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _as_field(hint, value):
    """A JSON value as the port's ``ModelConfig`` field of type ``hint``
    takes it: a list as a tuple, an object as the field's dataclass."""
    import dataclasses
    import typing

    if isinstance(value, list):
        return tuple(value)
    if isinstance(value, dict):
        for t in (hint, *typing.get_args(hint)):
            if dataclasses.is_dataclass(t):
                return t(**value)
    return value


def port_config(cfg: dict, name: str, **overrides):
    """The port's ``ModelConfig`` for a configuration file: the fields that
    its family reads from the published keys, then the file's ``port`` block
    (the family and any other field) as it stands, then ``overrides``."""
    import typing

    from repro_torch.configs import AdapterConfig, ModelConfig

    from fedbench import families

    a = cfg["nano_adapter"]
    kw = dict(families.load(cfg).port_fields(cfg), name=name,
              adapter=AdapterConfig(rank=a["rank"], alpha=a["alpha"],
                                    modalities=tuple(a["modalities"]), dtype=a["dtype"]),
              remat=True, use_pallas=True)
    hints = typing.get_type_hints(ModelConfig)
    kw.update({k: _as_field(hints[k], v) for k, v in cfg["port"].items()})
    kw.update(overrides)
    return ModelConfig(**kw)


def require_cards(chips: int) -> None:
    """Exit without a result unless ``chips`` CUDA cards are visible."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"fedbench: the cell needs {chips} CUDA card(s); {n} visible", file=sys.stderr)
        raise SystemExit(2)


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
        return float(out.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def device_info(chips: int, peak_bytes: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(peak_bytes), "power_limit_w": power_limit_w()}


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, list]:
    """{name: [number, limit]} for every compared number."""
    return {k: [float(numbers[k]), float(limits[k])] for k in limits}


def is_correct(checks: Dict[str, list]) -> bool:
    return all(math.isfinite(v) and v <= lim for v, lim in checks.values())


def apply_overrides(cell: Cell, cfg: Optional[dict] = None, traffic: Optional[dict] = None) -> Cell:
    """A copy of ``cell`` with some configuration or mix keys replaced (the
    tests' smaller sizes on the CPU)."""
    import dataclasses

    return dataclasses.replace(cell, cfg={**cell.cfg, **(cfg or {})},
                               traffic={**cell.traffic, **(traffic or {})})


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
            t_start: float, control: bool = False) -> dict:
    """One run of a cell -> the result line's object. The caller has checked
    the device; this function runs wherever ``device`` points. ``control``
    (``control.py`` only) judges the fp8 control instead of the program."""
    out = generator(cell.traffic).run(Ctx(cell=cell, seed=seed, seconds=seconds, trace=trace,
                                          device=device, t_start=t_start, control=control))
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = load_reader(m["name"])(out["record"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out["end_to_end"][m["name"]], "unit": m["unit"]}
    checks = out["checks"]
    result = {"correct": is_correct(checks), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics}
    if device.startswith("cuda"):
        result["device"] = device_info(cell.chips, out["memory_peak_bytes"])
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 0,
                            "memory_peak_bytes": 0}
    tr = out["record"].get("trace")
    if tr:
        result["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = tr["breakdown"]
    result["checks"] = {k: [_finite(v), lim] for k, (v, lim) in checks.items()}
    return result
