"""Shape grids and tolerances for holding each kernel against its plain version.

The port's copy of the grids and the tolerance policy of the JAX package's
``tests/kernel_harness.py`` (``tests/test_torch_kernels.py`` checks that the
copies agree), plus the full-width shapes that llava-1.5-7b serving gives
the kernels. ``chip_smoke.py`` and ``tests/test_torch_kernels_cuda.py`` run
them on the card.

A comparison passes when |got − want| ≤ rtol·|want| + atol_scale·max(1, ‖want‖∞).
"""
from __future__ import annotations

import torch

TOLERANCES = {
    "float32": {"rtol": 1e-6, "atol_scale": 1e-6},
    "bfloat16": {"rtol": 2e-2, "atol_scale": 2e-2},
}

LORA_SHAPES = [
    # (t, d, rank, block_t)
    (32, 32, 4, 32),
    (31, 32, 4, 32),
    (33, 32, 4, 32),
    (1, 48, 8, 32),
    (100, 96, 8, 32),
    (64, 33, 1, 16),
]

GROUPED_LORA_SHAPES = [
    # (t, d, rank, n_adapters, block_t)
    (16, 32, 4, 3, 16),
    (15, 32, 4, 3, 16),
    (17, 32, 4, 3, 16),
    (50, 48, 8, 5, 16),
]

FLASH_SHAPES = [
    # (label, b, sq, sk, h, hkv, d, causal, window, softcap, bq, bk)
    ("exact", 1, 16, 16, 2, 2, 32, True, None, 0.0, 16, 16),
    ("bound-1", 1, 15, 15, 2, 2, 32, True, None, 0.0, 16, 16),
    ("bound+1", 1, 17, 17, 2, 2, 32, True, None, 0.0, 16, 16),
    ("gqa-ragged", 2, 24, 24, 4, 2, 32, True, None, 0.0, 16, 16),
    ("mqa-window", 1, 40, 40, 4, 1, 32, True, 8, 0.0, 16, 16),
    ("decode", 1, 1, 33, 2, 1, 32, True, None, 0.0, 16, 16),
    ("bidir", 1, 24, 24, 2, 2, 64, False, None, 0.0, 16, 16),
    ("softcap", 1, 32, 32, 2, 2, 32, True, None, 10.0, 16, 16),
]

# Full-width llava-1.5-7b serving (prefill_len 128, 64 image patches, 8 slots,
# 8 adapter slots, rank 64), and the one head dim the grids above miss.
FULL_LORA_SHAPES = [(128, 4096, 64, 0), (64, 4096, 64, 0)]      # text, image adapters
FULL_GROUPED_SHAPES = [(8, 4096, 64, 8, 0)]                      # decode step
FULL_FLASH_SHAPES = [
    ("llava-prefill", 1, 192, 192, 32, 32, 128, True, None, 0.0, 0, 0),
    ("hd256-gqa-window", 1, 70, 70, 4, 2, 256, True, 24, 0.0, 0, 0),
]


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max()) if want.numel() else 0.0


def check_close(got: torch.Tensor, want: torch.Tensor, dtype: str, what: str = "") -> float:
    """Raise AssertionError unless ``got`` is within TOLERANCES of ``want``;
    return the largest absolute difference."""
    tol = TOLERANCES[dtype]
    g, w = got.float(), want.float()
    if g.shape != w.shape:
        raise AssertionError(f"{what}: shape {tuple(g.shape)} != {tuple(w.shape)}")
    scale = max(1.0, float(w.abs().max())) if w.numel() else 1.0
    bad = (g - w).abs() > tol["rtol"] * w.abs() + tol["atol_scale"] * scale
    if bool(bad.any()) or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{what} [{dtype}]: {int(bad.sum())} elements out of tolerance, "
                             f"max |err| {max_abs_err(g, w):.3e} (scale {scale:.3e})")
    return max_abs_err(g, w)
