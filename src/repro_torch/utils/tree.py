"""Tree helpers of the port (the parts of ``repro.utils.tree`` the training
slice needs). A tree is nested dicts and lists (a backbone's ``layers``)
whose leaves are tensors."""
from __future__ import annotations

import torch


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over one or more trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree):
    """Leaves in insertion order (the order ``tree_map`` visits them)."""
    if isinstance(tree, (dict, list)):
        return [leaf for v in (tree.values() if isinstance(tree, dict) else tree)
                for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` in ``tree_leaves`` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def tree_bytes(tree) -> int:
    """Total bytes, by each leaf's dtype."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def tree_zeros_like(tree, dtype=None):
    return tree_map(lambda x: torch.zeros_like(x, dtype=dtype), tree)
