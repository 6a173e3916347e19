"""The card's constants and the named layouts of the launch layer
(counterpart of ``repro.launch.mesh``, whose constants are a TPU v5e's).

The card is an NVIDIA H100 SXM: NVIDIA's data-sheet peaks, dense, at the
full 700 W power limit (a card set below it runs slower under load). The
roofline's denominators and ``chip_smoke.py``'s kernel bounds read them
here.

A layout is an ordered dict of axis sizes, the shape of a mesh, over which
the sharding rules resolve their logical specs (``repro_torch.sharding.
resolve_spec``): "1x1" one card; "1x8" one eight-card NVLink node with the
model axis over its cards; "16x16" and "2x16x16" the JAX package's single-
and multi-pod meshes, kept so that per-card footprints can be held against
the JAX package's. Importing this module touches no device.
"""
from __future__ import annotations

import math
from typing import Dict

# operations/s by type: bf16 and fp16 tensor cores, TF32 tensor cores, f32 on
# the CUDA cores
PEAK_OPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80 * 2**30

LAYOUTS: Dict[str, Dict[str, int]] = {
    "1x1": {"data": 1, "model": 1},
    "1x8": {"data": 1, "model": 8},
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
}


def layout(name: str) -> Dict[str, int]:
    if name not in LAYOUTS:
        raise KeyError(f"unknown layout {name!r}; known: {sorted(LAYOUTS)}")
    return dict(LAYOUTS[name])


def layout_chips(lay: Dict[str, int]) -> int:
    return math.prod(lay.values())
