"""Operations and bytes that a cell's work requires, and the card's peaks.

The peaks and ``bound_s`` serve every family; the rest counts the decoder
families (``dense``, ``vlm``), which ``families/dense.py`` hands on. A family
of another shape brings its counts in its own module.

Everything here is computed from a configuration file's keys and from the
traffic (sequence lengths, supervised positions, the rows and adapters of a
decode step), never from the program. "Required" is the work the inputs
need, whatever implements it: the matrix products of the forward, of the
gradient with respect to activations through the frozen backbone, and of the
adapters' gradients. It leaves out the frozen weights' gradients, the remat
recompute, embedding gathers, norms and element-wise work, and padding: a
row's required positions end at its last supervised position (causal
attention: nothing after it moves the loss), and the head is needed only at
supervised positions. So an implementation can never do less than this, and
a share of a peak computed from it stays at or under 100%.

Operations count a multiply-add as two. The peaks are NVIDIA's data sheet
for the H100 SXM at its 700 W limit: 989e12 dense bf16 operations/s on the
tensor cores and 3.35e12 bytes/s of HBM.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Tuple

PEAK_BF16_OPS = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16 = 2
F32 = 4


@dataclass(frozen=True)
class Shape:
    """The sizes of a configuration file that the counts read."""

    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    rank: int
    frontend: int   # the image stub's patch width, 0 without images
    window: int = 0  # sliding attention window, 0 for full causal attention

    @property
    def layer_params(self) -> int:
        """Matrix weights of one layer: q, k, v, o and the SwiGLU MLP's three."""
        qo = 2 * self.d * self.heads * self.head_dim
        kv = 2 * self.d * self.kv_heads * self.head_dim
        return qo + kv + 3 * self.d * self.d_ff


def sliding_window(cfg: dict) -> int:
    """The configuration's attention window (published as ``sliding_window``,
    off where ``use_sliding_window`` says so), 0 without one."""
    if cfg.get("use_sliding_window") is False:
        return 0
    return int(cfg.get("sliding_window") or 0)


def shape_of(cfg: dict) -> Shape:
    heads = cfg["num_attention_heads"]
    stub = cfg.get("frontend_stub") or {}
    return Shape(layers=cfg["num_hidden_layers"], d=cfg["hidden_size"], heads=heads,
                 kv_heads=cfg["num_key_value_heads"],
                 head_dim=cfg.get("head_dim") or cfg["hidden_size"] // heads,
                 d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
                 rank=cfg["nano_adapter"]["rank"], frontend=stub.get("width", 0),
                 window=sliding_window(cfg))


def causal_pairs(n: int, window: int = 0) -> int:
    """(query, key) pairs of causal attention over ``n`` positions, each
    query over its last ``window`` keys where a window is set."""
    if not window or n <= window:
        return n * (n + 1) // 2
    return window * (window + 1) // 2 + (n - window) * window


def attention_flops(s: Shape, pairs: int) -> int:
    """One layer's scores and weighted values over ``pairs`` (query, key) pairs."""
    return 4 * s.heads * s.head_dim * pairs


def train_row_flops(s: Shape, n: int, supervised: int, patches: int = 0) -> int:
    """Forward and backward of one training row: ``n`` required positions
    (image patches included), ``supervised`` of them in the loss, the first
    ``patches`` from the image stub. The backward runs to the adapters at the
    input: the activations' gradient of every layer (two products per weight
    product; four per attention product), the head's at supervised positions,
    and the adapters' own gradients (dA and dB: three products per forward
    product, the adapters' input being frozen)."""
    pairs = causal_pairs(n, s.window)
    fwd = s.layers * (2 * s.layer_params * n + attention_flops(s, pairs))
    bwd = s.layers * (2 * s.layer_params * n + 2 * attention_flops(s, pairs))
    head = 2 * (2 * s.vocab * s.d * supervised)
    connector = 2 * s.frontend * s.d * patches
    adapters = (4 + 6) * s.d * s.rank * n
    return fwd + bwd + head + connector + adapters


def prefill_flops(s: Shape, n: int, adapted: bool) -> int:
    """A prompt of ``n`` positions: every layer, and the head at its last."""
    return (s.layers * (2 * s.layer_params * n + attention_flops(s, causal_pairs(n, s.window)))
            + 2 * s.vocab * s.d + (4 * s.d * s.rank * n if adapted else 0))


def decode_flops(s: Shape, pos: int, adapted: bool) -> int:
    """One token at position ``pos`` (it attends ``pos + 1`` keys, at most
    the window) and its logits."""
    keys = min(pos + 1, s.window) if s.window else pos + 1
    return (s.layers * (2 * s.layer_params + attention_flops(s, keys))
            + 2 * s.vocab * s.d + (4 * s.d * s.rank if adapted else 0))


def flash_call(s: Shape, lengths: Iterable[int]) -> Tuple[int, int]:
    """(operations, bytes) of one layer's causal attention forward over rows
    of the given required lengths: q, k, v read once, the output and the
    per-row log-sum-exp written once, in bf16 (the LSE in f32)."""
    ops = nbytes = 0
    for n in lengths:
        ops += attention_flops(s, causal_pairs(n, s.window))
        nbytes += (BF16 * n * (2 * s.heads + 2 * s.kv_heads) * s.head_dim
                   + F32 * n * s.heads)
    return ops, nbytes


def grouped_lora_call(s: Shape, rows: int, adapters: int) -> Tuple[int, int]:
    """(operations, bytes) of one decode step's grouped adapter: ``rows``
    rows that carry a tenant, each read and written in bf16 with its slot
    index, and ``adapters`` distinct f32 (D, r) + (r, D) pairs read once."""
    return (4 * s.d * s.rank * rows,
            rows * (2 * BF16 * s.d + 4) + adapters * 2 * F32 * s.d * s.rank)


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card takes: the larger of the two bounds."""
    return max(ops / PEAK_BF16_OPS, nbytes / HBM_BYTES_PER_S)

