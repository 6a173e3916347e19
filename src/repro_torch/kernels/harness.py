"""Shape grids and tolerances for holding each kernel against its plain version.

The port's copy of the grids and the tolerance policy of the JAX package's
``tests/kernel_harness.py`` (``tests/test_torch_kernels.py`` checks that the
copies agree), plus the full-width shapes that llava-1.5-7b and
mamba2-130m give the kernels in serving and in training. ``chip_smoke.py`` and ``tests/test_torch_kernels_cuda.py`` run
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
# The SSD scan: the JAX harness's override for bf16 (the chunked
# recurrence's exp/cumsum chains lose more mantissa than one matmul); f32 is
# the common 1e-6.
SSD_TOLERANCES = {
    "float32": {"rtol": 1e-6, "atol_scale": 1e-6},
    "bfloat16": {"rtol": 5e-2, "atol_scale": 5e-2},
}
# ... at mamba2-130m's full width (N 128, chunk 256), where L = cumsum(dt·A)
# reaches -30 and beyond inside a chunk: the kernel's sequential f32 prefix
# and the plain version's torch.cumsum round L_i - L_j differently by a few
# ulps of |L|, and sums run over 256 steps and 128 state entries. Measured on
# an H100 at 700 W (chip_smoke.py phase 12a): kernel vs plain 2.7e-6 and
# 2.9e-6 of max(1, ‖ref‖∞) forward, 2.4e-6 and 1.3e-6 for the gradients; a
# float64 scan is 2.1e-6 and 2.2e-6 from the kernel and 1.5e-6 and 2.2e-6
# from the plain version, so neither f32 path holds 1e-6 there. The bound
# is about 3x the measured gap.
FULL_SSD_TOLERANCES = {
    "float32": {"rtol": 1e-5, "atol_scale": 1e-5},
    "bfloat16": {"rtol": 5e-2, "atol_scale": 5e-2},
}

# The bf16 tensor-core kernels against their rounding models
# (flash_attention/ref.py::attention_bf16_model, lora/ref.py::
# lora_residual_split_tf32), on the card. Measured on an H100 at 700 W
# (chip_smoke.py's parity phase, grid + full-width + tile-edge shapes, two
# runs): LoRA 4.3e-3 to 5.1e-3 of max(1, ‖ref‖∞) at most, 0.12 % to 0.2 % of
# elements differing by one bf16 ulp (f32 sums in another order round to
# the other side); flash 2.0e-3 to 3.9e-3, 14 % to 18 % of elements (the
# kernel rounds P against its running max, the model against the row's
# final max). The bound, rtol 8e-3 with atol 4e-3 of max(1, ‖ref‖∞), holds
# those gaps and sits well under the bf16 tolerance of 2e-2.
BF16_MODEL_TOLERANCES = {
    "bfloat16": {"rtol": 8e-3, "atol_scale": 4e-3},
}
# The tolerance above passes any one-ulp difference, so it cannot tell the
# split-TF32 LoRA from single-pass TF32 or bf16-rounded adapters. The share
# of output elements that differ from the split-TF32 model can: 0.2 % at
# most for the kernel on the H100, 12 % to 15 % for single-pass TF32 and
# 43 % to 49 % for bf16 adapters (chip_smoke.py's [accuracy] lines). Held
# per shape; one element may differ whatever the shape's size.
LORA_MODEL_MAX_SHARE = 1e-2

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

SSD_SHAPES = [
    # (b, s, h, p, n, chunk): 15/16/17 around one chunk, a ragged multi-chunk
    # case and an odd head width
    (1, 16, 2, 16, 8, 16),
    (1, 15, 2, 16, 8, 16),
    (1, 17, 2, 16, 8, 16),
    (2, 100, 3, 32, 16, 32),
    (1, 64, 2, 33, 8, 16),
]

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
# Full-width mamba2-130m (d_model 768): the text adapter at prefill_len 512,
# the grouped bank at 8 decode slots, training's 4 x 1024 text rows, and the
# server's merge of 2 clients' 768 x 64 leaves.
MAMBA_LORA_SHAPES = [(512, 768, 64, 0), (4 * 1024, 768, 64, 0)]
MAMBA_GROUPED_SHAPES = [(8, 768, 64, 8, 0)]
MAMBA_LORA_GRAD_SHAPES = [(4 * 1024, 768, 64, 0)]
MAMBA_FISHER_SHAPES = [(2, 768 * 64, 0)]
# ... and its SSD scan: H 24, P 64, N 128, chunk 256, at serving's prefill
# (batch 1 x 512: two chunks) and training's batch (4 x 1024: four chunks).
FULL_SSD_SHAPES = [(1, 512, 24, 64, 128, 256), (4, 1024, 24, 64, 128, 256)]
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


# Edges of the bf16 tensor-core tiles (64 rows, 64 keys; LoRA's 64-row
# tiles, 8-column fragments and 16-byte copies), run on the card only.
FLASH_EDGE_SHAPES = [
    # (label, b, sq, sk, h, hkv, d, causal, window, softcap, bq, bk)
    ("s63-d64", 1, 63, 63, 2, 1, 64, True, None, 0.0, 0, 0),
    ("s64", 1, 64, 64, 2, 2, 128, True, None, 0.0, 0, 0),
    ("s65", 1, 65, 65, 2, 2, 128, True, None, 0.0, 0, 0),
    ("s129-gqa", 2, 129, 129, 4, 2, 128, True, None, 0.0, 0, 0),
    ("q63-k129", 1, 63, 129, 2, 2, 64, True, None, 0.0, 0, 0),
    ("q65-k64", 1, 65, 64, 2, 2, 128, True, None, 0.0, 0, 0),
    ("bidir-q129-k65-d32", 1, 129, 65, 2, 2, 32, False, None, 0.0, 0, 0),
    ("d32-softcap-s65", 1, 65, 65, 2, 2, 32, True, None, 20.0, 0, 0),
    ("d256-window-s129", 1, 129, 129, 2, 1, 256, True, 40, 0.0, 0, 0),
    ("d256-s64", 1, 64, 64, 2, 2, 256, True, None, 0.0, 0, 0),
    ("decode-k129", 2, 1, 129, 4, 2, 128, True, None, 0.0, 0, 0),
    # causal with Sq - Sk >= 64: two whole 64-row tiles see no key (dead rows)
    ("dead-tiles-q130-k1", 1, 130, 1, 2, 2, 128, True, None, 0.0, 0, 0),
]
LORA_EDGE_SHAPES = [
    # (t, d, rank, block_t): D and r off multiples of 8 and 16, T off 64
    (63, 100, 5, 0),
    (65, 36, 12, 0),
    (129, 1000, 20, 0),
    (64, 4100, 64, 0),
    (130, 772, 36, 0),
    (1, 4096, 256, 0),
    (200, 770, 129, 0),
]


def check_share(got: torch.Tensor, want: torch.Tensor, limit: float, what: str = "") -> float:
    """Raise AssertionError if more than ``limit`` of the elements differ (at
    least one may); return the share that differs."""
    n_diff = int((got.float() != want.float()).sum())
    share = n_diff / max(1, want.numel())
    if n_diff > max(1, int(limit * want.numel())):
        raise AssertionError(f"{what}: {n_diff} of {want.numel()} elements differ "
                             f"({share:.3e}, limit {limit})")
    return share


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
