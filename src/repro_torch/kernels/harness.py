"""Shape grids and tolerances for holding each kernel against its plain version.

The port's copy of the grids and the tolerance policy of the JAX package's
``tests/kernel_harness.py`` (``tests/test_torch_kernels.py`` checks that the
copies agree), plus the full-width shapes that llava-1.5-7b serving gives
the kernels, the gradient cases and the Fisher-merge shapes that training
gives them. ``chip_smoke.py`` and ``tests/test_torch_kernels_cuda.py`` run
them on the card.

A comparison passes when |got − want| ≤ rtol·|want| + atol_scale·max(1, ‖want‖∞).
"""
from __future__ import annotations

import torch

TOLERANCES = {
    "float32": {"rtol": 1e-6, "atol_scale": 1e-6},
    "bfloat16": {"rtol": 2e-2, "atol_scale": 2e-2},
}
# Flash-attention gradients: the JAX harness's own override
# (``TOLERANCE_OVERRIDES["flash_attention_grad", ...]``). The backward's
# D-trick, p·(g·vᵀ − rowsum(g∘o)), cancels in f32 one reduction deeper than
# the forward: a row that sees one key has ds = 0 exactly but gets rounding
# noise, 1.1e-6 to 1.8e-6 of ‖ref‖∞ in the masked-rows case on the CPU.
FLASH_GRAD_TOLERANCES = {
    "float32": {"rtol": 2e-6, "atol_scale": 2e-6},
    "bfloat16": {"rtol": 3e-2, "atol_scale": 3e-2},
}
# ... and at llava's full training width, q/k/v (4, 96, 32, 128), where the
# D-trick's noise grows with the 96 keys a row sums over: on the CPU the
# Function's f32 dq is 2.5e-6 to 3.4e-6 of ‖ref‖∞ from autograd through the
# plain version, and 2.5e-6 from a float64 reference, where autograd is 8e-7.
FULL_FLASH_GRAD_TOLERANCES = {
    "float32": {"rtol": 1e-5, "atol_scale": 1e-5},
    "bfloat16": {"rtol": 3e-2, "atol_scale": 3e-2},
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

FISHER_SHAPES = [
    # (k, n, block_n)
    (5, 256, 256),
    (5, 255, 256),
    (5, 257, 256),
    (1, 100, 64),
    (16, 7, 256),
    (3, 1000, 256),
]
# K in {1, 3, 8} at N off every multiple of the TPU kernel's 1024-wide blocks
FISHER_EXTRA_SHAPES = [(1, 3000, 1024), (3, 1025, 1024), (8, 2047, 1024)]

# Gradient cases: the JAX harness's LoRA grad shapes and its flash grad picks,
# plus bidirectional attention and rows that see no key (Sq > Sk, causal).
LORA_GRAD_SHAPES = [(37, 48, 8, 16), (16, 32, 4, 16), (33, 32, 8, 32)]
FLASH_GRAD_SHAPES = [FLASH_SHAPES[i] for i in (2, 3, 4, 5, 6, 7)] + [
    ("masked-rows", 1, 6, 4, 2, 2, 32, True, None, 0.0, 16, 16),
]

# Full-width llava-1.5-7b serving (prefill_len 128, 64 image patches, 8 slots,
# 8 adapter slots, rank 64), and the one head dim the grids above miss.
FULL_LORA_SHAPES = [(128, 4096, 64, 0), (64, 4096, 64, 0)]      # text, image adapters
FULL_GROUPED_SHAPES = [(8, 4096, 64, 8, 0)]                      # decode step
# Full-width llava-1.5-7b training (batch 4 of 64 patches + 32 text tokens:
# 96 positions), and the server's merge of 2 clients' 4096 x 64 adapter leaves.
# NanoEdge gives the LoRA kernel the text rows (4 x 32) and the image rows
# (4 x 64) apart; (384, 4096) is the whole step's rows in one call.
FULL_LORA_GRAD_SHAPES = [(4 * 32, 4096, 64, 0), (4 * 64, 4096, 64, 0), (4 * 96, 4096, 64, 0)]
FULL_FLASH_GRAD_SHAPES = [("llava-train", 4, 96, 96, 32, 32, 128, True, None, 0.0, 0, 0)]
FULL_FISHER_SHAPES = [(2, 4096 * 64, 0)]
FULL_FLASH_SHAPES = [
    ("llava-prefill", 1, 192, 192, 32, 32, 128, True, None, 0.0, 0, 0),
    ("hd256-gqa-window", 1, 70, 70, 4, 2, 256, True, 24, 0.0, 0, 0),
]


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max()) if want.numel() else 0.0


def check_close(got: torch.Tensor, want: torch.Tensor, dtype: str, what: str = "",
                tolerances=None) -> float:
    """Raise AssertionError unless ``got`` is within ``tolerances`` (default
    TOLERANCES) of ``want``; return the largest absolute difference."""
    tol = (tolerances or TOLERANCES)[dtype]
    g, w = got.float(), want.float()
    if g.shape != w.shape:
        raise AssertionError(f"{what}: shape {tuple(g.shape)} != {tuple(w.shape)}")
    scale = max(1.0, float(w.abs().max())) if w.numel() else 1.0
    bad = (g - w).abs() > tol["rtol"] * w.abs() + tol["atol_scale"] * scale
    if bool(bad.any()) or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{what} [{dtype}]: {int(bad.sum())} elements out of tolerance, "
                             f"max |err| {max_abs_err(g, w):.3e} (scale {scale:.3e})")
    return max_abs_err(g, w)
