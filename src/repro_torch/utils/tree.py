"""Tree helpers of the port (``repro.utils.tree``). A tree is nested dicts,
lists and tuples (a backbone's ``layers``, a decode state's ``KVCache`` and
recurrent states, flattened field by field) whose leaves are tensors;
``None`` is an empty subtree, as in JAX (a hybrid stack with no extra
layers). Dicts are walked in sorted key order, as ``jax.tree_util`` flattens
them, so two trees with the same keys give their leaves in the same order
whatever order their dicts were built in (the Fisher merge pairs an
upload's θ and F leaf by leaf)."""
from __future__ import annotations

import math

import numpy as np
import torch


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over one or more trees of the same structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        if isinstance(tree, list):
            return out
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return fn(tree, *rest)


def tree_leaves(tree):
    """Leaves in the order ``tree_map`` visits them (dicts by sorted key)."""
    if tree is None:
        return []
    if isinstance(tree, (dict, list, tuple)):
        return [leaf for v in ([tree[k] for k in sorted(tree)] if isinstance(tree, dict)
                               else tree)
                for leaf in tree_leaves(v)]
    return [tree]


def tree_flatten_with_path(tree, prefix: str = ""):
    """[(path, leaf)] with the JAX package's checkpoint keys
    (``repro/checkpoint/io.py::_path_str``): a dict key, a sequence index or
    a NamedTuple field name, joined by ``/`` under ``prefix``; dicts in
    sorted key order, as ``jax.tree_util`` flattens them. A bare leaf maps to
    ``prefix`` itself; ``None`` has no leaves. So ``AdamWState(mu, nu,
    step)`` under ``opt`` gives ``opt/mu/text/down`` ... ``opt/step``."""
    join = (lambda k: f"{prefix}/{k}") if prefix else str
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    return [kv for k, v in items for kv in tree_flatten_with_path(v, join(k))]


def tree_map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over every leaf, the paths those of
    :func:`tree_flatten_with_path`; the structure kept."""
    join = (lambda k: f"{prefix}/{k}") if prefix else str
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], join(k)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        named = hasattr(tree, "_fields")
        out = [tree_map_with_path(fn, v, join(k))
               for k, v in zip(tree._fields if named else range(len(tree)), tree)]
        if isinstance(tree, list):
            return out
        return type(tree)(*out) if named else tuple(out)
    return fn(prefix, tree)


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` in ``tree_leaves`` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def tree_size(tree) -> int:
    """Total number of scalar parameters."""
    return sum(math.prod(x.shape) for x in tree_leaves(tree))


def tree_bytes(tree) -> int:
    """Total bytes, by each leaf's dtype."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def tree_zeros_like(tree, dtype=None):
    return tree_map(lambda x: torch.zeros_like(x, dtype=dtype), tree)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(tree, s):
    return tree_map(lambda x: x * s, tree)


def tree_dot(a, b):
    """Σ of elementwise products over two trees: a 0-d tensor, each leaf's
    sum added in ``tree_leaves`` order to an f32 zero (``jax.tree_util.
    tree_reduce(jnp.add, ..., jnp.float32(0.0))``), on the first leaf's device."""
    la, lb = tree_leaves(a), tree_leaves(b)
    total = torch.zeros((), dtype=torch.float32, device=la[0].device if la else None)
    for x, y in zip(la, lb):
        total = total + (x * y).sum()
    return total


def tree_sq_norm(tree):
    """Σ x² over every leaf: a 0-d tensor, summed leaf by leaf in
    ``tree_leaves`` order from an f32 zero (``tree_dot(tree, tree)``)."""
    total = None
    for x in tree_leaves(tree):
        s = (x * x).sum()
        total = s if total is None else total + s
    return total if total is not None else torch.zeros(())


def tree_stack(trees):
    """Stack identically structured trees along a new leading axis
    (``repro.utils.tree_stack``), on the device where the leaves lie: the
    cohort engine's (K, ...) client rows."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def tree_unstack(tree, n: int):
    """Inverse of :func:`tree_stack`: ``n`` trees, tree i holding row i of
    every leaf (a view of the stacked leaf)."""
    return [tree_map(lambda x, i=i: x[i], tree) for i in range(n)]


def tree_weighted_sum(trees, weights):
    """Σ_k w_k · tree_k in f32 (``jnp.tensordot(w, stack.astype(f32), axes=1)``):
    the streaming FedAvg's fold of one chunk."""
    w = torch.as_tensor([float(x) for x in weights], dtype=torch.float32)

    def leaf(*xs):
        stacked = torch.stack([x.float() for x in xs])
        return torch.tensordot(w.to(stacked.device), stacked, dims=1)

    return tree_map(leaf, trees[0], *trees[1:])


def tree_cast(tree, dtype):
    return tree_map(lambda x: x.to(dtype), tree)


def _host(x) -> np.ndarray:
    """A leaf as a numpy array on the host (bf16, which numpy lacks, widened
    to f32 exactly)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def tree_allclose(a, b, rtol=1e-5, atol=1e-6) -> bool:
    """``np.allclose`` leaf by leaf, wherever the tensors lie."""
    return all(bool(np.allclose(_host(x), _host(y), rtol=rtol, atol=atol))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def fmt_params(n: int) -> str:
    if n >= 1e9:
        return f"{n / 1e9:.2f}B"
    if n >= 1e6:
        return f"{n / 1e6:.2f}M"
    if n >= 1e3:
        return f"{n / 1e3:.2f}K"
    return str(n)


def fmt_bytes(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if n < 1024 or unit == "TiB":
            return f"{n:.2f}{unit}" if unit != "B" else f"{n}B"
        n /= 1024
    return f"{n}B"
