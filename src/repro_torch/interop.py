"""Weight exchange between the JAX package and the port, through numpy.

The JAX package's params, exported as nested dicts of numpy arrays (for
example ``jax.tree.map(np.asarray, params)``), become the port's params, and
back. The only change of layout is the layer stacks: the JAX package stacks
per-layer params on a leading axis for ``lax.scan``
(``transformer.py:118-128``), the port keeps a list of per-layer dicts.
The stacks are ``layers`` (n_layers), the hybrid family's ``triples``
(n_layers // 3, each {"rec0", "rec1", "attn"}) and ``extras`` (n_layers %
3, or None), and the encoder-decoder's ``enc_layers`` (n_enc_layers) and
``dec_layers`` (n_layers); each stack's leading axis is checked against the
config in both directions. Every leaf of a layer is unstacked and restacked
alike: the projections, the norms (LayerNorm's scale and bias too), for the
QKV-bias configs ``bq``/``bk``/``bv``, for the MoE family the f32 router
(d, E) inside a bf16 backbone, the experts' (E, d, f) and (E, f, d) weights
(``w_gate`` too, which GELU never reads) and the shared expert's MLP, and
for RG-LRU its f32 ``b_a``, ``b_x`` and ``lam`` inside a bf16 backbone. The
rest (embeddings, the learned ``pos`` and ``enc_pos`` tables,
``enc_final_norm``, the connector) passes as it is.
Projections keep the ``(in, out)`` layout in both packages, so nothing is
transposed. bfloat16 arrays (numpy's ``bfloat16`` from ``ml_dtypes``) pass
bit for bit through their 16-bit pattern.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils import tree_leaves, tree_map


def tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """bf16 comes back as f32 (numpy has no bfloat16 of its own); exact."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _stack_depths(cfg):
    """{stack name: (its layer count, the config's expression for it)} for
    the stacks the config's family has."""
    if cfg.family == "hybrid":
        n_t = cfg.n_layers // 3
        return {"triples": (n_t, "n_layers // 3"), "extras": (cfg.n_layers - 3 * n_t,
                                                               "n_layers % 3")}
    if cfg.family == "audio":
        return {"enc_layers": (cfg.n_enc_layers, "n_enc_layers"),
                "dec_layers": (cfg.n_layers, "n_layers")}
    return {"layers": (cfg.n_layers, "n_layers")}


def _check_depth(name, got, depth) -> None:
    n, what = depth
    if got != {n}:
        raise ValueError(f"stacked {name} axis {sorted(got)} != {what} {n}")


def backbone_from_numpy(cfg, tree, device):
    """JAX-layout backbone params (numpy) -> the port's params on ``device``."""
    depths = _stack_depths(cfg)
    out = {k: tree_map(lambda a: tensor_from_numpy(a, device), v)
           for k, v in tree.items() if k not in depths}
    for name, depth in depths.items():
        n = depth[0]
        if tree.get(name) is None:
            _check_depth(name, {0}, depth)
            out[name] = None
            continue
        stacked = tree_map(lambda a: tensor_from_numpy(a, device), tree[name])
        _check_depth(name, {t.shape[0] for t in tree_leaves(stacked)}, depth)
        out[name] = [tree_map(lambda t: t[i].contiguous(), stacked) for i in range(n)]
    return out


def backbone_to_numpy(params, cfg):
    """The port's params -> JAX layout (numpy), restacking the layer lists,
    each list's length checked against the config."""
    depths = _stack_depths(cfg)
    out = {k: tree_map(tensor_to_numpy, v) for k, v in params.items() if k not in depths}
    for name, depth in depths.items():
        layers = params[name] or []
        _check_depth(name, {len(layers)}, depth)
        if not layers:
            out[name] = None
            continue
        layers = [tree_map(tensor_to_numpy, lp) for lp in layers]
        out[name] = tree_map(lambda *leaves: np.stack(leaves), layers[0], *layers[1:])
    return out


def adapters_from_numpy(tree, device):
    """{modality: {"down", "up"}} numpy -> tensors on ``device``.

    Also carries any adapter-shaped tree: Fisher diagonals, AdamW moments.
    """
    return tree_map(lambda a: tensor_from_numpy(a, device), tree)


def adapters_to_numpy(tree):
    return tree_map(tensor_to_numpy, tree)


def adamw_state_from_numpy(state, device):
    """The JAX package's ``AdamWState(mu, nu, step)`` as numpy -> the port's."""
    from repro_torch.optim import AdamWState

    return AdamWState(mu=adapters_from_numpy(state.mu, device),
                      nu=adapters_from_numpy(state.nu, device),
                      step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                                        device=device))


def adamw_state_to_numpy(state):
    """-> (mu, nu, step) numpy, the fields of the JAX package's ``AdamWState``."""
    return (adapters_to_numpy(state.mu), adapters_to_numpy(state.nu),
            np.asarray(int(state.step), np.int32))

