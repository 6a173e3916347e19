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
# those gaps and sits well under the bf16 tolerance of 2e-2. It holds flash
# attention's bf16 backward kernel (csrc/flash_attention_bwd.cu) against
# flash_attention/ref.py::attention_bwd_bf16_model too: the two round P, and
# split dS, alike, so what remains is the f32 sums' order, an element on the
# other side of a bf16 rounding boundary and the gradients' own rounding to
# bf16, whose ulp the rtol passes anywhere (measured on an H100 at 700 W at
# the training cells' shapes and five tile edges: at most 3.5e-3 of
# max(1, ‖ref‖∞), 0.01 % to 1.6 % of the elements differing).
BF16_MODEL_TOLERANCES = {
    "bfloat16": {"rtol": 8e-3, "atol_scale": 4e-3},
}
# The bf16 SSD kernel (csrc/ssd_scan.cu) is held at the same bound against
# ssd_scan/ref.py::ssd_chunked_bf16_model: measured on an H100 at 700 W
# (chip_smoke.py's [ssd-parity] line, grid, edge and full-width shapes),
# 2.4e-3 of max(1, ‖ref‖∞) at most, and 1.8e-4 of its elements differing
# (f32 sums in another order round to the other side). The exact plain
# version differs from the model in 39.6 % and 39.9 % of the elements at
# the full-width shapes ([accuracy] lines; tests/test_torch_kernels.py
# asserts that it fails this limit), so 1 % tells the modelled rounding
# from none.
SSD_MODEL_MAX_SHARE = 1e-2
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
# Adapter trees for the tree wrappers (one kernel launch a tree), (k, leaf
# sizes): trees of 1, 3 and 4 leaves of unequal sizes, with a single-element
# leaf and sizes off every multiple of 4 and 8 (the kernel's 16-byte vectors).
FISHER_TREES = [(3, (1000,)), (2, (1, 37, 256)), (5, (257, 1, 1023, 64))]

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
# text, image adapters; one row: the naive loop's per-token text adapter
FULL_LORA_SHAPES = [(128, 4096, 64, 0), (64, 4096, 64, 0), (1, 4096, 64, 0)]
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
# Edges of the SSD kernel's phases and tiles (64-step query and key tiles,
# 16-wide tensor-core fragments), run on the card: five chunks (the carried
# state passed over three), batch 3 with H 5 and a ragged last chunk, S 1,
# P 33 with N 24 and 8, S below the chunk (Q = S = 100, off 16 and 64), and
# chunk 64 (one query tile) with a two-step last chunk.
SSD_EDGE_SHAPES = [
    # (b, s, h, p, n, chunk)
    (1, 160, 2, 32, 16, 32),
    (3, 300, 5, 64, 128, 256),
    (1, 1, 2, 16, 8, 16),
    (2, 100, 3, 33, 24, 32),
    (1, 70, 3, 33, 8, 64),
    (1, 100, 3, 64, 128, 256),
    (2, 130, 2, 64, 128, 64),
]

# Full-width llava-1.5-7b training (batch 4 of 64 patches + 32 text tokens:
# 96 positions), and the server's merge of 2 clients' 4096 x 64 adapter leaves.
# NanoEdge gives the LoRA kernel the text rows (4 x 32) and the image rows
# (4 x 64) apart; (384, 4096) is the whole step's rows in one call.
FULL_LORA_GRAD_SHAPES = [(4 * 32, 4096, 64, 0), (4 * 64, 4096, 64, 0), (4 * 96, 4096, 64, 0)]
FULL_FLASH_GRAD_SHAPES = [("llava-train", 4, 96, 96, 32, 32, 128, True, None, 0.0, 0, 0)]
# The vmap engine's batched LoRA (lora_residual_many), (k, t, d, rank): small
# cohorts for the CPU tests; llava's cohort of K = 4 clients at batch 4 (the
# text rows 4 x 32 and the image rows 4 x 64 of each), and K = 1, 3 and 8 at
# the text rows; then the tile edges: t off the f32 kernel's 8-row units and
# the bf16 kernel's 64-row tiles (1, 7, 17, 63, 65, 129 rows), d off the
# 64-column blocks and off multiples of 8 (33, 40, 130), ranks 1, 24 and 72.
MANY_LORA_SHAPES = [(3, 37, 48, 8), (2, 16, 32, 4), (1, 33, 32, 8), (5, 1, 48, 8)]
FULL_MANY_LORA_SHAPES = [(4, 128, 4096, 64), (4, 256, 4096, 64), (1, 128, 4096, 64),
                         (3, 128, 4096, 64), (8, 128, 4096, 64)]
MANY_LORA_EDGE_SHAPES = [(3, 65, 96, 16), (2, 63, 33, 1), (4, 17, 130, 24), (2, 129, 64, 72),
                         (6, 7, 40, 8)]
MANY_LORA_GRAD_SHAPES = [(3, 37, 48, 8), (4, 128, 4096, 64), (4, 256, 4096, 64)]
FULL_FISHER_SHAPES = [(2, 4096 * 64, 0)]
# Rank-heterogeneous NanoAdapters (core/hetero.py) at llava-1.5-7b's width:
# one client's text rows (batch 4 x 32) through rank-16 and rank-32 adapters,
# a vmap cohort of 4 at rank 16; and the merge of clients at ranks 16 and 32
# padded to rank 64, (ranks, rank_max, d_model): each client's Fisher is zero
# on its padding, so the columns of ``down`` (rows of ``up``) past 32 carry no
# client's mass and must merge to exactly 0.
HETERO_LORA_SHAPES = [(128, 4096, 16, 0), (128, 4096, 32, 0)]
HETERO_MANY_LORA_SHAPES = [(4, 128, 4096, 16)]
HETERO_FISHER_PAD = ((16, 32), 64, 4096)
# ... and whole adapter trees: llava-1.5-7b's four (4096, 64) and (64, 4096)
# leaves (text and image, down and up), mamba2-130m's two (768, 64) and
# (64, 768), each at K = 1, 2 (the training path) and 5 (the CLI's default);
# then the tree kernel's edges: 512 clients on one leaf, K x L past the
# pointers one launch holds (1536, so 520 clients take two launches) and
# more leaves than one launch holds (32).
FULL_FISHER_TREES = [(k, (4096 * 64,) * 4) for k in (1, 2, 5)]
MAMBA_FISHER_TREES = [(k, (768 * 64,) * 2) for k in (1, 2, 5)]
FISHER_TREE_EDGES = [(512, (20003,)), (520, (1000, 1001, 1002, 1003)), (2, (33,) * 40)]
FULL_FLASH_SHAPES = [
    ("llava-prefill", 1, 192, 192, 32, 32, 128, True, None, 0.0, 0, 0),
    ("hd256-gqa-window", 1, 70, 70, 4, 2, 256, True, 24, 0.0, 0, 0),
    # the naive loop's unpadded prefill: 64 patches + a 3-token prompt, off the tiles
    ("llava-naive-prefill", 1, 67, 67, 32, 32, 128, True, None, 0.0, 0, 0),
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
    # head dim 80 (h2o-danube-1.8b): GQA 4 as h2o's 32 / 8, windows that cut
    # tiles, Sq != Sk both ways, softcap, and a non-causal case
    ("d80-s65-gqa4", 1, 65, 65, 8, 2, 80, True, None, 0.0, 0, 0),
    ("d80-window-s129-gqa4", 2, 129, 129, 8, 2, 80, True, 40, 0.0, 0, 0),
    ("d80-q63-k130-gqa4", 1, 63, 130, 4, 1, 80, True, 70, 0.0, 0, 0),
    ("d80-q130-k65-window", 1, 130, 65, 4, 1, 80, True, 32, 0.0, 0, 0),
    ("d80-softcap-s64", 1, 64, 64, 8, 2, 80, True, None, 30.0, 0, 0),
    ("d80-bidir-q17-k129", 1, 17, 129, 4, 1, 80, False, None, 0.0, 0, 0),
    # grok-1's softcap of 30 at the MoE family's GQA groups: 5 (llama4-scout,
    # 40 heads on 8) and 6 (grok-1, 48 on 8), off the 64-row tiles
    ("d128-gqa5-softcap30-s70", 1, 70, 70, 10, 2, 128, True, None, 30.0, 0, 0),
    ("d64-gqa6-softcap30-s65", 2, 65, 65, 12, 2, 64, True, None, 30.0, 0, 0),
]
# The dense family's full-width attention shapes, run on the card only:
# h2o-danube-1.8b's prefill (4,096 positions), its training batch and the
# 6,144-position window step (the 4,096-key window masks keys there), and the
# training batch of glm4-9b (GQA 16), qwen1.5-4b (20 heads, MHA) and
# internlm2-20b (GQA 6).
DENSE_FLASH_SHAPES = [
    ("h2o-prefill", 1, 4096, 4096, 32, 8, 80, True, 4096, 0.0, 0, 0),
    ("h2o-train", 4, 32, 32, 32, 8, 80, True, 4096, 0.0, 0, 0),
    ("h2o-window-6144", 1, 6144, 6144, 32, 8, 80, True, 4096, 0.0, 0, 0),
    ("glm4-train", 4, 32, 32, 32, 2, 128, True, None, 0.0, 0, 0),
    ("qwen1.5-train", 4, 32, 32, 20, 20, 128, True, None, 0.0, 0, 0),
    ("internlm2-train", 4, 32, 32, 48, 8, 128, True, None, 0.0, 0, 0),
]
# The MoE family's and qwen2-vl-72b's full-width attention, run on the card
# only: serving's prefill (128 text positions; qwen2-vl 64 patches + 128) and
# the training batch (4 x 32 tokens; qwen2-vl 4 x (64 + 32)), all at head dim
# 128 on 8 KV heads: grok-1 48 heads with its softcap of 30, llama4-scout 40
# (GQA 5), qwen2-vl 64.
MOE_FLASH_SHAPES = [
    ("grok-prefill", 1, 128, 128, 48, 8, 128, True, None, 30.0, 0, 0),
    ("llama4-prefill", 1, 128, 128, 40, 8, 128, True, None, 0.0, 0, 0),
    ("qwen2vl-prefill", 1, 192, 192, 64, 8, 128, True, None, 0.0, 0, 0),
    ("grok-train", 4, 32, 32, 48, 8, 128, True, None, 30.0, 0, 0),
    ("llama4-train", 4, 32, 32, 40, 8, 128, True, None, 0.0, 0, 0),
    ("qwen2vl-train", 4, 96, 96, 64, 8, 128, True, None, 0.0, 0, 0),
]
# ... and the flash Function's gradient with the softcap: grok-1's training
# batch, and a GQA-5 case off the tiles. Both are held at
# FULL_FLASH_GRAD_TOLERANCES: at head dim 128 the D-trick's f32 noise passes
# the grid's 2e-6 (dq 2.55e-6 of ‖ref‖∞ from autograd at the GQA-5 case on
# the CPU, 2.1e-6 on an H100 at 700 W).
MOE_FLASH_GRAD_SHAPES = [MOE_FLASH_SHAPES[3], FLASH_EDGE_SHAPES[-2]]
# ... and their NanoEdge and tenant-bank LoRA at rank 64, on the card only:
# the text adapter's rows at d_model 5,120 (llama4-scout), 6,144 (grok-1) and
# 8,192 (qwen2-vl), 128 a prefill and 4 x 32 a training step; qwen2-vl's
# image adapter over 64 patches a prefill and 4 x 64 a step; the grouped
# bank at 8 decode slots of 8 tenants at each width.
MOE_LORA_SHAPES = [(128, 5120, 64, 0), (128, 6144, 64, 0), (128, 8192, 64, 0),
                   (64, 8192, 64, 0), (4 * 64, 8192, 64, 0)]
MOE_LORA_GRAD_SHAPES = [(4 * 32, 5120, 64, 0), (4 * 32, 6144, 64, 0), (4 * 32, 8192, 64, 0),
                        (4 * 64, 8192, 64, 0)]
MOE_GROUPED_SHAPES = [(8, 5120, 64, 8, 0), (8, 6144, 64, 8, 0), (8, 8192, 64, 8, 0)]
# The hybrid family's full-width attention, run on the card only:
# recurrentgemma-9b's 16 heads of 256 on one KV head (GQA 16) at its local
# window of 2,048: serving's prefill at prefill_len 2,048, the training batch
# (4 x 32) and a 4,096-position forward, where the window masks keys.
HYBRID_FLASH_SHAPES = [
    ("rgemma-prefill", 1, 2048, 2048, 16, 1, 256, True, 2048, 0.0, 0, 0),
    ("rgemma-train", 4, 32, 32, 16, 1, 256, True, 2048, 0.0, 0, 0),
    ("rgemma-window-4096", 1, 4096, 4096, 16, 1, 256, True, 2048, 0.0, 0, 0),
]
# ... and the audio family's decoder self-attention (whisper-base: 8 heads of
# 64, MHA, causal, no window): serving's prefill at prefill_len 128 and the
# training batch (4 x 32). Its encoder and cross-attention run sdpa.
AUDIO_FLASH_SHAPES = [
    ("whisper-prefill", 1, 128, 128, 8, 8, 64, True, None, 0.0, 0, 0),
    ("whisper-train", 4, 32, 32, 8, 8, 64, True, None, 0.0, 0, 0),
]
# ... the flash Function's gradient at both training batches, held at
# FULL_FLASH_GRAD_TOLERANCES (head dim 256 sums the widest dot products)
NEW_FAMILY_FLASH_GRAD_SHAPES = [HYBRID_FLASH_SHAPES[1], AUDIO_FLASH_SHAPES[1]]
# The bf16 backward kernel (csrc/flash_attention_bwd.cu), run on the card
# only, beside the gradient grids above and FLASH_EDGE_SHAPES: the two
# training cells' attention (qwen2-vl-72b's cohort of 8 clients x 4 rows of
# 64 patches + 192 tokens, GQA 8; internlm2-20b's 4 rows of 2,048 tokens,
# GQA 6), then edges of its 64-key and 64-query tiles that those miss: GQA 3
# at Sq < Sk, head dim 256 (32-row query tiles, dK and dV in two column
# halves) with GQA 2 and a window off the tiles, and with Sq < Sk and the
# softcap; a window without the causal mask; Sq > Sk under a window, where
# whole query tiles see no key.
FLASH_BWD_SHAPES = [
    ("qwen2vl-cohort-train", 32, 256, 256, 64, 8, 128, True, None, 0.0, 0, 0),
    ("internlm2-longdoc-train", 4, 2048, 2048, 48, 8, 128, True, None, 0.0, 0, 0),
    ("bwd-q63-k129-gqa3", 1, 63, 129, 6, 2, 64, True, None, 0.0, 0, 0),
    ("bwd-d256-gqa2-window-s150", 1, 150, 150, 4, 2, 256, True, 40, 0.0, 0, 0),
    ("bwd-d256-q33-k100-softcap", 2, 33, 100, 2, 1, 256, True, None, 30.0, 0, 0),
    ("bwd-bidir-window-s150", 1, 150, 150, 2, 1, 64, False, 50, 0.0, 0, 0),
    ("bwd-q200-k70-window-dead", 1, 200, 70, 4, 2, 128, True, 30, 0.0, 0, 0),
]
# ... and their LoRA at rank 64: whisper's image adapter over 1,500 frames a
# request and 4 x 1,500 a training step, its text adapter over a 128-token
# prefill and 4 x 32 tokens, all at d_model 512; recurrentgemma's text
# adapter over its 2,048-token prefill (its 4 x 32 rows at d_model 4,096 are
# llava's FULL_LORA_GRAD_SHAPES[0]); the grouped bank at d_model 512.
NEW_FAMILY_LORA_SHAPES = [(1500, 512, 64, 0), (4 * 1500, 512, 64, 0), (128, 512, 64, 0),
                          (4 * 32, 512, 64, 0), (2048, 4096, 64, 0)]
NEW_FAMILY_LORA_GRAD_SHAPES = [(4 * 1500, 512, 64, 0), (4 * 32, 512, 64, 0)]
AUDIO_GROUPED_SHAPES = [(8, 512, 64, 8, 0)]
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
# Edges of the grouped kernel (csrc/lora.cu, namespace cc): its work units
# (adapters in use x 8-row tiles), its rank groups of 16 columns, its 16-byte
# copies and its identity rows. ``ids`` names the pattern of ``grouped_ids``;
# ``offset`` shifts x by that many elements inside a larger buffer, which
# breaks 16-byte alignment. Widths are mamba2-130m's 768 or below: at
# llava's 4096 two correct f32 sum orders already differ by more than the
# f32 tolerance (the port's plain version and the JAX kernel, both within
# 1.2e-6 of a float64 sum, are 1.3e-6 of max(1, ‖ref‖∞) apart at T 1 on the
# CPU). llava's width is held by FULL_GROUPED_SHAPES on the card.
GROUPED_LORA_EDGE_SHAPES = [
    # (label, t, d, rank, n_adapters, ids, offset)
    ("t1", 1, 768, 64, 8, "one", 0),
    ("all-identity", 8, 768, 64, 8, "none", 0),
    ("ids-beyond-n", 8, 768, 64, 8, "beyond", 0),
    ("one-in-use", 8, 768, 64, 8, "one", 0),
    ("all-in-use", 8, 768, 64, 8, "all", 0),
    ("r4", 8, 96, 4, 3, "mixed", 0),
    ("r8", 16, 520, 8, 4, "mixed", 0),
    ("r128", 8, 1024, 128, 4, "mixed", 0),
    ("r256", 8, 512, 256, 3, "mixed", 0),
    ("d33", 9, 33, 16, 3, "mixed", 0),
    ("d770", 8, 770, 64, 8, "mixed", 0),
    ("t64-8-adapters", 64, 768, 64, 8, "all", 0),
    ("x-offset-1", 8, 768, 64, 8, "mixed", 1),
]


def grouped_ids(kind: str, t: int, n: int, seed: int) -> torch.Tensor:
    """Adapter ids (t,) int32 on the CPU for a ``GROUPED_LORA_EDGE_SHAPES``
    pattern: ``mixed`` uniform in [-1, n) (identity rows included); ``none``
    all -1; ``beyond`` uniform in [-1, 2n), so about half the rows carry an
    id >= n and come back as x; ``one`` every row adapter n // 2; ``all``
    every adapter in use (each on t // n or more rows), in shuffled order."""
    gen = torch.Generator().manual_seed(seed)
    if kind == "mixed":
        ids = torch.randint(-1, n, (t,), generator=gen)
    elif kind == "none":
        ids = torch.full((t,), -1)
    elif kind == "beyond":
        ids = torch.randint(-1, 2 * n, (t,), generator=gen)
    elif kind == "one":
        ids = torch.full((t,), n // 2)
    elif kind == "all":
        if t < n:
            raise ValueError(f"grouped_ids: 'all' needs t >= n, got t {t}, n {n}")
        ids = (torch.arange(t) % n)[torch.randperm(t, generator=gen)]
    else:
        raise ValueError(f"grouped_ids: unknown pattern {kind!r}")
    return ids.to(torch.int32)


def offset_view(t: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts ``offset`` elements into a
    larger buffer (offset 0: ``t`` itself)."""
    if offset == 0:
        return t
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


def ssd_tolerances(b, s, h, p, n, chunk):
    """FULL_SSD_TOLERANCES where its reason holds, mamba2-130m's state width
    and whole 256-step chunks (N 128, min(chunk, S) 256); SSD_TOLERANCES
    elsewhere."""
    return FULL_SSD_TOLERANCES if (n, min(chunk, s)) == (128, 256) else SSD_TOLERANCES


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
