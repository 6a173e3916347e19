"""Upload compression: int8 quantization of adapter deltas with error
feedback (``repro.core.compression``).

The delta θ_k − θ_global carries a round's information; quantizing it to
int8 with one f32 scale per leaf cuts the upload 4× below f32, and the
error-feedback residual (Seide et al. 2014; Karimireddy et al. 2019) is
added back into the next round's delta before quantization. Every step is
exact IEEE arithmetic (a max, a division, round half to even, a clip), so
the port's payloads equal the JAX package's bit for bit on equal inputs.

Wire format per leaf: the int8 payload and one f32 scale.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.utils import (tree_add, tree_leaves, tree_map, tree_size, tree_sub,
                               tree_unflatten, tree_zeros_like)


class QuantizedDelta(NamedTuple):
    payload: Dict    # int8 tree
    scales: Dict     # f32 0-d tensors, one per leaf
    wire_bytes: int  # bytes on the wire


def _quant_leaf(x):
    amax = x.abs().max()
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dequant_leaf(q, scale):
    return q.to(torch.float32) * scale


def quantize_delta(delta) -> QuantizedDelta:
    qs = [_quant_leaf(x) for x in tree_leaves(delta)]
    payload = tree_unflatten(delta, [q for q, _ in qs])
    scales = tree_unflatten(delta, [s for _, s in qs])
    wire = tree_size(delta) * 1 + 4 * len(qs)
    return QuantizedDelta(payload=payload, scales=scales, wire_bytes=wire)


def dequantize_delta(q: QuantizedDelta):
    return tree_map(_dequant_leaf, q.payload, q.scales)


def compress_update(adapters, global_ref,
                    error_acc: Optional[Dict] = None) -> Tuple[QuantizedDelta, Dict]:
    """Client side: delta = (θ_k − θ_global) + error feedback, quantized.
    -> (wire message, new error accumulator)."""
    delta = tree_sub(adapters, global_ref)
    if error_acc is not None:
        delta = tree_add(delta, error_acc)
    q = quantize_delta(delta)
    return q, tree_sub(delta, dequantize_delta(q))


def apply_update(global_ref, recon_delta):
    """Server side: θ_k as the aggregator sees it, the reconstructed delta
    cast to each global leaf's dtype."""
    return tree_add(global_ref, tree_map(lambda a, b: a.to(b.dtype), recon_delta, global_ref))


def init_error_feedback(adapters) -> Dict:
    return tree_zeros_like(adapters)
