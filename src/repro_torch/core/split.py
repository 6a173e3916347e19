"""Split-learning runtime (``repro.core.split``): the mechanics FedNano's
Alg. 1 leaves implicit.

The client cannot backpropagate through a server-hosted LLM, so each local
step is a three-message exchange:

    1. client:  NanoEdge forward  ->  adapted embeddings E            (up)
    2. server:  frozen-LLM fwd+bwd ->  loss, ∂loss/∂E                 (down)
    3. client:  adapter backward through NanoEdge -> adapter grads    (local)

The client half builds an autograd graph over the adapters only and hands
the wire tensors on detached; the server half differentiates the backbone
loss with respect to its *inputs* alone (the backbone's tensors never
require grad); the client's backward is seeded with the server's
cotangents. The composition equals the fused gradient of
``fednano_loss``, while every cross-machine tensor is explicit and counted
in bytes.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import adapters as adapters_lib
from repro_torch.core.types import Batch
from repro_torch.models import model as model_lib
from repro_torch.models.layers import torch_dtype
from repro_torch.utils import tree_bytes, tree_leaves, tree_map, tree_unflatten


# ---------------------------------------------------------------------------
# client half
# ---------------------------------------------------------------------------

def client_forward(cfg, backbone_client_side, adapters, batch: Batch):
    """NanoEdge forward. ``backbone_client_side`` holds the frozen pieces the
    client owns (token embedder, connector): a subset of the server's params
    in this simulation, a separate copy on a real device."""
    return adapters_lib.nanoedge_forward(cfg, backbone_client_side, adapters, batch)


def client_forward_vjp(cfg, backbone_client_side, adapters, batch: Batch):
    """-> ((embeds, positions, labels, mask, enc), vjp): the wire tensors
    detached, and ``vjp(cotangents) -> (adapter_grads,)`` for cotangents
    ``(d_embeds,)`` or, with an encoder stream, ``(d_embeds, d_enc)``. An
    adapter the forward does not read gets a zero gradient, as ``jax.vjp``
    gives it. The graph lives until ``vjp`` runs its backward."""
    adp = tree_map(lambda t: t.detach().requires_grad_(True), adapters)
    embeds, positions, labels, mask, enc = adapters_lib.nanoedge_forward(
        cfg, backbone_client_side, adp, batch)
    wire = (embeds, enc) if enc is not None else (embeds,)
    leaves = tree_leaves(adp)

    def vjp(cotangents):
        grads = torch.autograd.grad(wire, leaves, grad_outputs=tuple(cotangents),
                                    allow_unused=True)
        return (tree_unflatten(adp, [torch.zeros_like(x) if g is None else g
                                     for g, x in zip(grads, leaves)]),)

    return (embeds.detach(), positions, labels, mask,
            enc.detach() if enc is not None else None), vjp


# ---------------------------------------------------------------------------
# server half
# ---------------------------------------------------------------------------

def make_server_step(cfg) -> Callable:
    """The frozen backbone's forward and backward with respect to the INPUT
    activations: ``(backbone, embeds, positions, labels, mask, enc) ->
    (loss, d_embeds, d_enc)`` (``d_enc`` None without an encoder stream)."""

    def server_step(backbone, embeds, positions, labels, mask, enc):
        e = embeds.detach().requires_grad_(True)
        en = enc.detach().requires_grad_(True) if enc is not None else None
        loss, _ = model_lib.loss_fn(cfg, backbone, e, positions, labels, mask, en)
        grads = torch.autograd.grad(loss, (e, en) if en is not None else (e,))
        return loss.detach(), grads[0], grads[1] if en is not None else None

    return server_step


# ---------------------------------------------------------------------------
# full split step (simulated exchange, counted in bytes)
# ---------------------------------------------------------------------------

def split_train_grads(cfg, backbone, adapters, batch: Batch):
    """One split-learning gradient computation -> (loss, adapter_grads,
    traffic {"act_up", "act_down"} in bytes). Equals the fused gradient of
    ``fednano_loss``."""
    (embeds, positions, labels, mask, enc), vjp = client_forward_vjp(cfg, backbone, adapters,
                                                                     batch)
    loss, d_embeds, d_enc = make_server_step(cfg)(backbone, embeds, positions, labels, mask,
                                                  enc)
    if enc is not None:
        (adapter_grads,) = vjp((d_embeds, d_enc))
        act_up = tree_bytes(embeds) + tree_bytes(enc)
        act_down = tree_bytes(d_embeds) + tree_bytes(d_enc)
    else:
        (adapter_grads,) = vjp((d_embeds,))
        act_up, act_down = tree_bytes(embeds), tree_bytes(d_embeds)
    return loss, adapter_grads, {"act_up": act_up, "act_down": act_down}


def split_activation_bytes_per_step(cfg, batch_size: int, seq_len: int,
                                    n_patches: int = None) -> dict:
    """Analytic per-step activation traffic (both directions), bytes.

    Equals the measured ``split_train_grads`` traffic: the wire carries the
    text-token embeddings (B, S, D) and, for an arch with a modality
    frontend, the connected encoder stream (B, M, D), whether it joins the
    decoder sequence (vlm) or goes as a separate cross-attention memory
    (audio). ``n_patches`` overrides the per-clip patch/frame count (0 for
    text-only batches on a multimodal arch); default
    :func:`~repro_torch.models.vision_stub.num_patches`.
    """
    from repro_torch.models.vision_stub import num_patches

    if n_patches is None:
        n_patches = num_patches(cfg) if cfg.frontend_dim else 0
    itemsize = torch_dtype(cfg.dtype).itemsize
    act = batch_size * (seq_len + n_patches) * cfg.d_model * itemsize
    return {"act_up": act, "act_down": act}
