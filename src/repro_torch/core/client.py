"""Client-side local tuning (Alg. 1, ClientUpdate; ``repro.core.client``).

Each client trains ONLY its NanoAdapters. The backbone is frozen: its
tensors never require grad, and gradients are taken with respect to the
adapter tree alone, so the server-hosted LLM is never perturbed.

``local_update`` is the sequential engine's path: download the global
adapters, run T AdamW steps, then FedNano's dedicated Fisher pass. The
cohort engines (``local_update_many``, vmap and sharded) and the FedDPA-F
personal adapter are ROADMAP queues 5 and 2.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core import adapters as adapters_lib
from repro_torch.core.fisher import fisher_pass
from repro_torch.core.types import Batch
from repro_torch.models import model as model_lib
from repro_torch.models.layers import token_accuracy
from repro_torch.optim import adamw_update
from repro_torch.utils import tree_leaves, tree_map


@dataclass(frozen=True)
class HyperParams:
    lr: float = 1e-3
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    local_steps: int = 10          # T local steps per round (paper: 1 epoch)
    fisher_batches: int = 4        # batches for the dedicated FIM pass
    # beyond-paper upload transforms (ROADMAP queue 2): run_federated raises if set.
    # FedProx's prox_mu, FedDPA-F's warmup and DP noise arrive with their code.
    compress_uploads: bool = False
    dp_clip: float = 0.0


@dataclass
class ClientState:
    cid: int
    adapters: Dict               # global/shared NanoAdapters (uploaded)
    opt_state: Any               # AdamWState, carried across rounds
    n_examples: int
    fisher: Optional[Dict] = None  # last computed diagonal FIM
    rounds_participated: int = 0  # local_update calls so far


def value_and_grad(loss_fn, adapters):
    """(loss, aux, grads) of ``loss_fn(adapters) -> (loss, aux)`` with respect
    to the adapter tree alone (fresh leaves that require grad)."""
    adp = tree_map(lambda t: t.detach().requires_grad_(True), adapters)
    loss, aux = loss_fn(adp)
    grads = iter(torch.autograd.grad(loss, tree_leaves(adp)))
    return loss.detach(), aux, tree_map(lambda _: next(grads), adp)


def train_step(cfg, strategy, hp: HyperParams, backbone, adapters, opt_state, batch: Batch,
               global_ref):
    """One local AdamW step on the shared adapters (``_train_step_body``).
    -> (adapters, opt_state, loss)."""

    def base_loss(adp):
        return adapters_lib.fednano_loss(cfg, backbone, adp, batch)

    loss, _, grads = value_and_grad(strategy.wrap_local_loss(base_loss, hp, global_ref),
                                    adapters)
    new_adapters, new_opt = adamw_update(grads, opt_state, adapters, lr=hp.lr,
                                         weight_decay=hp.weight_decay,
                                         grad_clip=hp.grad_clip)
    return new_adapters, new_opt, loss


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
    participated = state.rounds_participated
    # round start: adopt the global adapters (Alg. 1 ClientUpdate line 1)
    adapters = global_adapters if strategy.downloads_global(participated) else state.adapters
    opt_state = state.opt_state
    losses = []
    for t in range(hp.local_steps):
        adapters, opt_state, loss = train_step(cfg, strategy, hp, backbone, adapters,
                                               opt_state, batches[t % len(batches)],
                                               global_adapters)
        losses.append(float(loss))

    fisher = None
    if strategy.wants_fisher == "dedicated":
        fisher = fisher_pass(lambda adp, b: fisher_grad(cfg, backbone, adp, b), adapters,
                             batches[: hp.fisher_batches])
    elif strategy.wants_fisher is not None:
        raise NotImplementedError(f"wants_fisher={strategy.wants_fisher!r}: the streaming "
                                  "FIM of FedNano-EF is ROADMAP queue 2")

    new_state = dataclasses.replace(state, adapters=adapters, opt_state=opt_state,
                                    fisher=fisher, rounds_participated=participated + 1)
    if losses:
        metrics = {"loss_first": losses[0], "loss_last": losses[-1],
                   "loss_mean": sum(losses) / len(losses)}
    else:  # hp.local_steps == 0: a no-op round must stay NaN-free
        metrics = {"loss_first": 0.0, "loss_last": 0.0, "loss_mean": 0.0}
    return new_state, metrics


def _make_eval_fn(cfg):
    """Answer-token accuracy of one batch under teacher forcing."""

    @torch.no_grad()
    def acc_fn(backbone, adapters, batch: Batch):
        embeds, positions, labels, mask, _ = adapters_lib.nanoedge_forward(
            cfg, backbone, adapters, batch)
        hidden, _ = model_lib.forward(cfg, backbone, embeds, positions)
        return token_accuracy(model_lib.logits(cfg, backbone, hidden), labels, mask)

    return acc_fn


def eval_client(cfg, backbone, adapters, local_adapters, batches: List[Batch]) -> float:
    """Answer-token accuracy under teacher forcing (the VQA-accuracy proxy)."""
    if local_adapters is not None:
        raise NotImplementedError("personal adapters (FedDPA-F) are ROADMAP queue 2")
    acc_fn = _make_eval_fn(cfg)
    accs = [float(acc_fn(backbone, adapters, b)) for b in batches]
    return sum(accs) / max(len(accs), 1)
