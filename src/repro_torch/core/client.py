"""Client-side local tuning (Alg. 1, ClientUpdate; ``repro.core.client``).

Each client trains ONLY its NanoAdapters (and, for FedDPA-F, a personal
adapter beside them). The backbone is frozen: its tensors never require
grad, and gradients are taken with respect to the adapter tree alone, so the
server-hosted LLM is never perturbed.

Strategy-specific behaviour comes in through the ``repro_torch.strategies``
hooks (``wrap_local_loss``, ``wants_fisher``, ``downloads_global``,
``local_warmup``). ``local_update`` is the sequential engine's path:
download the global adapters, train the personal adapter in its warmup
rounds, run T AdamW steps, then estimate the diagonal FIM (a dedicated pass,
or the squared gradients of the T steps). ``client_ref_like`` gives the
structures a checkpointed client restores into. The cohort engines
(``local_update_many``, vmap and sharded) are ROADMAP queue 5c.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core import adapters as adapters_lib
from repro_torch.core.fisher import FisherAccumulator, fisher_pass
from repro_torch.core.types import Batch
from repro_torch.models import model as model_lib
from repro_torch.models.layers import token_accuracy
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.utils import tree_leaves, tree_map


@dataclass(frozen=True)
class HyperParams:
    lr: float = 1e-3
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    local_steps: int = 10          # T local steps per round (paper: 1 epoch)
    prox_mu: float = 0.01          # FedProx proximal coefficient
    fisher_batches: int = 4        # batches for the dedicated FIM pass
    dpa_warmup_rounds: int = 1     # FedDPA-F: rounds that train the personal adapter
    # --- beyond-paper extensions (repro_torch.core.{compression,privacy}) ---
    compress_uploads: bool = False # int8 delta quantization + error feedback
    dp_clip: float = 0.0           # client-level DP: L2 clip of the delta (0 = off)
    dp_noise: float = 0.0          # client-level DP: Gaussian noise multiplier


@dataclass
class ClientState:
    cid: int
    adapters: Dict               # global/shared NanoAdapters (uploaded)
    opt_state: Any               # AdamWState, carried across rounds
    n_examples: int
    local_adapters: Optional[Dict] = None   # FedDPA-F personal adapter
    fisher: Optional[Dict] = None           # last computed diagonal FIM
    rounds_participated: int = 0            # local_update calls so far (drives
                                            # download/warmup under sampling)
    local_opt_state: Any = None             # personal-adapter AdamW state,
                                            # carried across warmup rounds


def to_device(state: ClientState, device) -> ClientState:
    """A fresh client's adapters, personal adapters and AdamW state on ``device``."""
    move = lambda tree: tree_map(lambda t: t.to(device), tree)
    return dataclasses.replace(state, adapters=move(state.adapters),
                               local_adapters=move(state.local_adapters),
                               opt_state=move(state.opt_state))


def client_ref_like(state: ClientState) -> ClientState:
    """Reference structures for restoring a checkpointed ``ClientState``
    (``repro.core.client.client_ref_like``): a fresh client holds ``None``
    where a checkpointed one may hold tensors, so the Fisher slot gets an f32
    adapter-shaped template (both FIM estimators accumulate in f32) and,
    with personal adapters, the personal optimizer a fresh ``adamw_init``.
    Only structure, shapes, dtypes and devices matter."""
    fisher = state.fisher
    if fisher is None:
        fisher = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device),
                          state.adapters)
    local_opt_state = state.local_opt_state
    if local_opt_state is None and state.local_adapters is not None:
        local_opt_state = adamw_init(state.local_adapters)
    return dataclasses.replace(state, fisher=fisher, local_opt_state=local_opt_state)


def value_and_grad(loss_fn, adapters, allow_unused: bool = False):
    """(loss, aux, grads) of ``loss_fn(adapters) -> (loss, aux)`` with respect
    to the adapter tree alone (fresh leaves that require grad). With
    ``allow_unused``, a leaf the loss does not read gets a zero gradient, as
    ``jax.grad`` gives it (the personal image adapter of a family whose images
    join the embeddings); without it, such a leaf raises."""
    adp = tree_map(lambda t: t.detach().requires_grad_(True), adapters)
    loss, aux = loss_fn(adp)
    leaves = tree_leaves(adp)
    grads = torch.autograd.grad(loss, leaves, allow_unused=allow_unused)
    it = iter(torch.zeros_like(x) if g is None else g for g, x in zip(grads, leaves))
    return loss.detach(), aux, tree_map(lambda _: next(it), adp)


def combined_loss(cfg, backbone, adapters, local_adapters, batch: Batch):
    """FedDPA's composition (``_combined_loss``): NanoEdge with the shared
    adapters, then the personal adapters on its output. Without personal
    adapters, the FedNano loss. -> (loss, aux)."""
    if local_adapters is None:
        return adapters_lib.fednano_loss(cfg, backbone, adapters, batch)
    embeds, positions, labels, mask, enc = adapters_lib.nanoedge_forward(
        cfg, backbone, adapters, batch)
    embeds, enc = _apply_personal(cfg, local_adapters, embeds, enc, cfg.use_pallas)
    return model_lib.loss_fn(cfg, backbone, embeds, positions, labels, mask, enc)


def _apply_personal(cfg, local_adapters, embeds, enc, use_pallas: bool):
    """The personal text adapter on the whole embedding sequence (the image
    prefix included), the personal image adapter on the audio family's
    encoder stream only."""
    kw = dict(rank=cfg.adapter.rank, alpha=cfg.adapter.alpha, use_pallas=use_pallas)
    if "text" in local_adapters:
        embeds = adapters_lib.nano_adapter_apply(local_adapters["text"], embeds, **kw)
    if enc is not None and "image" in local_adapters:
        enc = adapters_lib.nano_adapter_apply(local_adapters["image"], enc, **kw)
    return embeds, enc


def train_step(cfg, strategy, hp: HyperParams, backbone, adapters, opt_state, batch: Batch,
               global_ref, local_adapters=None, fisher_acc: Optional[FisherAccumulator] = None):
    """One local AdamW step on the shared adapters (``_train_step_body``).
    ``fisher_acc`` gathers FedNano-EF's squared gradients of the wrapped loss.
    -> (adapters, opt_state, loss, fisher_acc)."""

    def base_loss(adp):
        return combined_loss(cfg, backbone, adp, local_adapters, batch)

    loss, _, grads = value_and_grad(strategy.wrap_local_loss(base_loss, hp, global_ref),
                                    adapters)
    new_adapters, new_opt = adamw_update(grads, opt_state, adapters, lr=hp.lr,
                                         weight_decay=hp.weight_decay,
                                         grad_clip=hp.grad_clip)
    if fisher_acc is not None:
        fisher_acc = fisher_acc.update(grads)
    return new_adapters, new_opt, loss, fisher_acc


def local_adapter_step(cfg, hp: HyperParams, backbone, adapters, local_adapters, opt_state,
                       batch: Batch):
    """FedDPA-F warmup step (``_local_adapter_step_body``): train the PERSONAL
    adapter, the shared one frozen. -> (local_adapters, opt_state, loss)."""
    loss, _, grads = value_and_grad(
        lambda ladp: combined_loss(cfg, backbone, adapters, ladp, batch), local_adapters,
        allow_unused=True)
    new_local, new_opt = adamw_update(grads, opt_state, local_adapters, lr=hp.lr,
                                      grad_clip=hp.grad_clip)
    return new_local, new_opt, loss


def fisher_grad(cfg, backbone, adapters, batch: Batch):
    """Gradient of the plain task loss, for the dedicated FIM pass
    (``_fisher_grad_body``)."""
    return value_and_grad(lambda adp: adapters_lib.fednano_loss(cfg, backbone, adp, batch),
                          adapters)[2]


def local_update(cfg, backbone, state: ClientState, batches: List[Batch], hp: HyperParams,
                 strategy, global_adapters, round_idx: int) -> Tuple[ClientState, Dict]:
    """Run T local steps (+ FIM estimation) for one client. Returns metrics.

    ``float(loss)`` after every step waits for the device, as the JAX loop does.
    """
    from repro_torch.strategies.base import get_strategy

    strategy = get_strategy(strategy)
    # the schedule hooks see the client's own participation count, so a
    # client first sampled in round r > 0 still starts its schedule then
    participated = state.rounds_participated
    # round start: adopt the global adapters (Alg. 1 ClientUpdate line 1)
    adapters = global_adapters if strategy.downloads_global(participated) else state.adapters
    opt_state = state.opt_state

    # personal-adapter warmup rounds (FedDPA-F), AdamW state carried across rounds
    local_adapters, local_opt_state = state.local_adapters, state.local_opt_state
    if local_adapters is not None and strategy.local_warmup(participated, hp):
        if local_opt_state is None:
            local_opt_state = adamw_init(local_adapters)
        for batch in batches[: hp.local_steps]:
            local_adapters, local_opt_state, _ = local_adapter_step(
                cfg, hp, backbone, adapters, local_adapters, local_opt_state, batch)

    acc = FisherAccumulator.init(adapters) if strategy.wants_fisher == "streaming" else None
    losses = []
    for t in range(hp.local_steps):
        adapters, opt_state, loss, acc = train_step(
            cfg, strategy, hp, backbone, adapters, opt_state, batches[t % len(batches)],
            global_adapters, local_adapters=local_adapters, fisher_acc=acc)
        losses.append(float(loss))

    fisher = None
    if strategy.wants_fisher == "dedicated":
        fisher = fisher_pass(lambda adp, b: fisher_grad(cfg, backbone, adp, b), adapters,
                             batches[: hp.fisher_batches])
    elif strategy.wants_fisher == "streaming":
        fisher = acc.finalize()

    new_state = dataclasses.replace(state, adapters=adapters, opt_state=opt_state,
                                    local_adapters=local_adapters,
                                    local_opt_state=local_opt_state, fisher=fisher,
                                    rounds_participated=participated + 1)
    if losses:
        metrics = {"loss_first": losses[0], "loss_last": losses[-1],
                   "loss_mean": sum(losses) / len(losses)}
    else:  # hp.local_steps == 0: a no-op round must stay NaN-free
        metrics = {"loss_first": 0.0, "loss_last": 0.0, "loss_mean": 0.0}
    return new_state, metrics


@torch.no_grad()
def _accuracy(cfg, backbone, adapters, local_adapters, batch: Batch):
    """Answer-token accuracy of one batch under teacher forcing."""
    embeds, positions, labels, mask, enc = adapters_lib.nanoedge_forward(
        cfg, backbone, adapters, batch)
    if local_adapters is not None:
        embeds, enc = _apply_personal(cfg, local_adapters, embeds, enc, cfg.use_pallas)
    hidden, _ = model_lib.forward(cfg, backbone, embeds, positions, enc)
    return token_accuracy(model_lib.logits(cfg, backbone, hidden), labels, mask)


def eval_client(cfg, backbone, adapters, local_adapters, batches: List[Batch]) -> float:
    """Answer-token accuracy under teacher forcing (the VQA-accuracy proxy)."""
    accs = [float(_accuracy(cfg, backbone, adapters, local_adapters, b)) for b in batches]
    return sum(accs) / max(len(accs), 1)
