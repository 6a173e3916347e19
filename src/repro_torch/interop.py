"""Weight exchange between the JAX package and the port, through numpy.

The JAX package's params, exported as nested dicts of numpy arrays (for
example ``jax.tree.map(np.asarray, params)``), become the port's params, and
back. The only change of layout is the layer stack: the JAX package stacks
per-layer params on a leading axis for ``lax.scan``
(``transformer.py:118-128``), the port keeps a list of per-layer dicts.
Every leaf of a layer is unstacked and restacked alike: the projections,
the norms, for the QKV-bias configs ``bq``/``bk``/``bv``, and for the MoE
family the f32 router (d, E) inside a bf16 backbone, the experts' (E, d, f)
and (E, f, d) weights (``w_gate`` too, which GELU never reads) and
the shared expert's MLP.
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


def backbone_from_numpy(cfg, tree, device):
    """JAX-layout backbone params (numpy) -> the port's params on ``device``."""
    out = {k: tree_map(lambda a: tensor_from_numpy(a, device), v)
           for k, v in tree.items() if k != "layers"}
    stacked = tree_map(lambda a: tensor_from_numpy(a, device), tree["layers"])
    n = cfg.n_layers

    def layer(i):
        return tree_map(lambda t: t[i].contiguous(), stacked)

    leading = {t.shape[0] for t in tree_leaves(stacked)}
    if leading != {n}:
        raise ValueError(f"stacked layer axis {sorted(leading)} != n_layers {n}")
    out["layers"] = [layer(i) for i in range(n)]
    return out


def backbone_to_numpy(params):
    """The port's params -> JAX layout (numpy), restacking the layer list."""
    out = {k: tree_map(tensor_to_numpy, v) for k, v in params.items() if k != "layers"}
    layers = [tree_map(tensor_to_numpy, lp) for lp in params["layers"]]

    def stack(*leaves):
        return np.stack(leaves)

    out["layers"] = tree_map(stack, layers[0], *layers[1:])
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

