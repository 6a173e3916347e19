"""Weights and adapters drawn from a run's seed, on the device, in the layout
the port's backbone takes (dicts of ``(in, out)`` projections, a list of
layers), and in the type they are served in. A family module lists its
backbone's leaves (``leaves(cfg)``); ``decoder_leaves`` lists the decoder
families'.

Leaves of one scale share one flat buffer, filled by ``normal_`` from one
``torch.Generator`` on the device in blocks of 2**30 elements; each leaf is
a contiguous view of its buffer. So a seed gives the same weights on every
card, and drawing 40 GB takes a few dozen calls. The program and the
plain reference read these same tensors; neither draws its own.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np
import torch

from fedbench.counts import Shape

BLOCK = 1 << 30


def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one stream of a run's draws, from the run's seed."""
    words = [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF] + [ord(c) for c in stream]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)


def decoder_leaves(s: Shape, qkv_bias: bool,
                   tied: bool = False) -> List[Tuple[tuple, tuple, Tuple[float, float]]]:
    """(path, shape, (mean, std)) of every backbone leaf; ``tied``: the
    logits read the embedding table, and there is no output table."""
    d, hd = s.d, s.head_dim
    q, kv = s.heads * hd, s.kv_heads * hd
    small = (0.0, 0.02)
    norm = (1.0, 0.05)
    out = [(("embed", "table"), (s.vocab, d), small),
           (("final_norm", "scale"), (d,), norm)]
    if not tied:
        out.insert(1, (("unembed", "table"), (s.vocab, d), small))
    if s.frontend:
        out += [(("connector", "w"), (s.frontend, d), (0.0, s.frontend ** -0.5)),
                (("connector", "b"), (d,), small)]
    for i in range(s.layers):
        lay = ("layers", i)
        out += [(lay + ("norm1", "scale"), (d,), norm),
                (lay + ("norm2", "scale"), (d,), norm),
                (lay + ("attn", "wq"), (d, q), (0.0, d ** -0.5)),
                (lay + ("attn", "wk"), (d, kv), (0.0, d ** -0.5)),
                (lay + ("attn", "wv"), (d, kv), (0.0, d ** -0.5)),
                (lay + ("attn", "wo"), (q, d), (0.0, q ** -0.5)),
                (lay + ("mlp", "w_gate"), (d, s.d_ff), (0.0, d ** -0.5)),
                (lay + ("mlp", "w_up"), (d, s.d_ff), (0.0, d ** -0.5)),
                (lay + ("mlp", "w_down"), (s.d_ff, d), (0.0, s.d_ff ** -0.5))]
        if qkv_bias:
            out += [(lay + ("attn", "bq"), (q,), small), (lay + ("attn", "bk"), (kv,), small),
                    (lay + ("attn", "bv"), (kv,), small)]
    return out


def _put(tree: dict, path: tuple, value) -> None:
    node = tree
    for key in path[:-1]:
        if key == "layers":
            node = node.setdefault("layers", [])
            continue
        if isinstance(node, list):
            while len(node) <= key:
                node.append({})
            node = node[key]
        else:
            node = node.setdefault(key, {})
    node[path[-1]] = value


def draw_backbone(leaves, seed: int, device, dtype=torch.bfloat16) -> Dict:
    """The frozen backbone of a run, drawn from ``seed`` on ``device``;
    ``leaves`` as ``decoder_leaves`` gives them."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "backbone"))
    groups: Dict[Tuple[float, float], list] = defaultdict(list)
    for path, shape, scale in leaves:
        groups[scale].append((path, shape))
    tree: Dict = {}
    for scale in sorted(groups):
        members = groups[scale]
        total = sum(int(np.prod(shape)) for _, shape in members)
        buf = torch.empty(total, dtype=dtype, device=device)
        for start in range(0, total, BLOCK):
            buf[start:start + BLOCK].normal_(scale[0], scale[1], generator=gen)
        at = 0
        for path, shape in members:
            n = int(np.prod(shape))
            _put(tree, path, buf[at:at + n].view(shape))
            at += n
    return tree


def draw_adapters(s: Shape, modalities, count: int, seed: int, stream: str, device,
                  up_std: float = 0.0) -> List[Dict]:
    """``count`` f32 NanoAdapter sets: ``down`` N(0, 1/D) (fan-in), ``up``
    N(0, up_std²), zero by default as a fresh adapter's is."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, stream))
    out = []
    for _ in range(count):
        adp = {}
        for mod in modalities:
            down = torch.empty((s.d, s.rank), device=device).normal_(0.0, s.d ** -0.5,
                                                                      generator=gen)
            up = torch.zeros((s.rank, s.d), device=device)
            if up_std:
                up.normal_(0.0, up_std, generator=gen)
            adp[mod] = {"down": down, "up": up}
        out.append(adp)
    return out
