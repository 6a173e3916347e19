"""Parameter, input and decode-state sharding rules over a layout
(counterpart of ``repro.launch.sharding_rules``).

Every tree leaf gets a logical spec from its path and shape; logical axes
are "data" (expanded to ("pod", "data") on the multi-pod layout) and
"model". ``repro_torch.sharding.resolve_spec`` drops the axes a layout
lacks and those that do not divide a dimension, which is the JAX package's
fallback to replication (qwen1.5's 20 heads, glm4's 2 KV heads, the
mamba2 and whisper vocabularies, a KV cache sharded on its head dim where
its KV heads do not divide the model axis). ``shard_shape`` then gives
each card's block, and ``sharded_bytes`` a tree's bytes on one card: the
launch layer's per-card footprint. The spec functions return {leaf path:
resolved spec}. The port places nothing by these specs; it runs one
process.

Paths are ``utils.tree_flatten_with_path``'s: dict keys in sorted order,
list indices and NamedTuple field names, as ``jax.tree_util`` names them, so
a decode state's ``KVCache``/``SSMState``/``RGLRUState`` leaves carry the
field names (``k``, ``conv``, ``h``) that the state rules read. The port's
layer stacks are lists of per-layer trees (``layers/0/attn/wq``), so no
parameter leaf carries the layer axis that JAX's ``_STACKED`` containers
give theirs, and each takes ``param_logical_spec`` as it is.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

from repro_torch.sharding import resolve_spec
from repro_torch.utils import tree_flatten_with_path

BATCH = "data"  # alias expanded to ("pod", "data") by the resolver


def _path_names(path: str) -> Tuple[str, ...]:
    return tuple(path.split("/")) if path else ()


def param_logical_spec(path_names: Tuple[str, ...], shape: Tuple[int, ...],
                       kind: str = "train"):
    """Logical spec of a parameter leaf without a layer axis
    (``sharding_rules.py:39-114``).

    ``kind`` selects the MoE experts' layout when the expert count does not
    divide the model axis (grok-1: 8 experts on 16): train and prefill shard
    the experts over (data, model), decode shards the FFN width over the
    whole layout (weight-stationary).
    """
    name = path_names[-1] if path_names else ""
    nd = len(shape)

    # embeddings
    if name == "table":
        return ("model", None)
    if name == "pos":
        return (None, None)

    # MoE expert weights (E, D, F) / (E, F, D)
    if "moe" in path_names and name in ("w_gate", "w_up") and nd == 3:
        if shape[0] % 16 == 0:
            return ("model", None, None)
        if kind == "decode":
            return (None, None, ("data", "model"))
        return (None, "data", "model")
    if "moe" in path_names and name == "w_down" and nd == 3:
        if shape[0] % 16 == 0:
            return ("model", None, None)
        if kind == "decode":
            return (None, ("data", "model"), None)
        return (None, "model", "data")
    if name == "router":
        return (None,) * nd

    # dense MLP
    if name in ("w_gate", "w_up"):
        return (None, "model")
    if name == "w_down":
        return ("model", None)

    # attention
    if name in ("wq", "wk", "wv"):
        return (None, "model")
    if name == "wo":
        return ("model", None)
    if name in ("bq", "bk", "bv"):
        return ("model",)

    # mamba2
    if name == "in_proj":
        return (None, "model")
    if name == "out_proj":
        return ("model", None)
    if name == "conv_w":
        return (None, "model")

    # RG-LRU
    if name in ("w_gate_branch", "w_rec_branch", "w_a", "w_x"):
        return (None, "model")
    if name == "w_out":
        return ("model", None)

    # norms, biases, gates, adapters, connector: replicated
    return (None,) * nd


def spec_for_param(path: str, leaf, kind: str = "train") -> Tuple:
    """A parameter leaf's logical spec (``sharding_rules.py:117-124``)."""
    return tuple(param_logical_spec(_path_names(path), tuple(leaf.shape), kind))


def _specs(fn, tree):
    """{leaf path: resolved spec} of ``fn(path, leaf)`` over every leaf."""
    return {path: fn(path, leaf) for path, leaf in tree_flatten_with_path(tree)}


def param_specs(layout: Dict[str, int], params, kind: str = "train"):
    """{path: resolved spec} of every parameter leaf (``make_param_shardings``)."""
    return _specs(lambda path, leaf: resolve_spec(layout, leaf.shape,
                                                  spec_for_param(path, leaf, kind)), params)


def replicated(tree):
    return _specs(lambda _, leaf: (None,) * leaf.dim(), tree)


# ---------------------------------------------------------------------------
# inputs / decode state
# ---------------------------------------------------------------------------

def batch_spec(ndim: int):
    """tokens/labels/mask (B, S[, ...]): batch over (pod, data)."""
    return (BATCH,) + (None,) * (ndim - 1)


def batch_specs(layout: Dict[str, int], batch):
    """``make_batch_shardings``: every leaf's batch axis over (pod, data)."""
    return _specs(lambda _, leaf: resolve_spec(layout, leaf.shape, batch_spec(leaf.dim())),
                  batch)


def _kv_cache_spec(layout: Dict[str, int], shape):
    """(L, B, C, kv, hd): batch over (pod, data); kv heads over model where
    they divide it, else the head dim (the documented fallback), else
    replicated."""
    model = layout.get("model", 1)
    _, _, _, kv, hd = shape
    if kv % model == 0:
        return (None, BATCH, None, "model", None)
    if hd % model == 0:
        return (None, BATCH, None, None, "model")
    return (None, BATCH, None, None, None)


def state_specs(layout: Dict[str, int], state):
    """Decode-state tree (``make_state_shardings``, ``sharding_rules.py:
    157-182``): KV caches (5-D), SSM and RG-LRU states (3-5-D), told apart
    by rank and by the path names ``h`` and ``conv``."""

    def f(path, leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 5:  # stacked KVCache (L, B, C, kv, hd)
            spec = _kv_cache_spec(layout, shape)
        elif len(shape) == 4:  # stacked SSM conv (L, B, w, conv) or RG-LRU conv
            spec = (None, BATCH, None, None)
        elif len(shape) == 3:  # stacked RG-LRU h (L, B, dr)
            spec = (None, BATCH, "model")
        elif len(shape) == 2:
            spec = (BATCH, None)
        else:
            spec = (None,) * len(shape)
        names = _path_names(path)
        if "h" in names and len(shape) == 5:  # stacked SSM h (L, B, H, P, N)
            spec = (None, BATCH, None, None, None)
        if "conv" in names:
            spec = (None, BATCH, None, None)[: len(shape)]
        return resolve_spec(layout, shape, spec)

    return _specs(f, state)


def shard_shape(shape, spec, layout: Dict[str, int]) -> Tuple[int, ...]:
    """One card's block of a ``shape`` under a resolved ``spec``."""
    return tuple(d if axes is None else d // math.prod(layout[a] for a in axes)
                 for d, axes in zip(shape, spec))


def sharded_bytes(tree, specs, layout: Dict[str, int]) -> int:
    """Exact bytes of ``tree`` on one card under its resolved ``specs``
    ({path: spec}, as the functions above give them)."""
    return sum(math.prod(shard_shape(leaf.shape, specs[path], layout)) * leaf.element_size()
               for path, leaf in tree_flatten_with_path(tree))
