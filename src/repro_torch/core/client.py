"""Client-side local tuning (Alg. 1, ClientUpdate; ``repro.core.client``).

Each client trains ONLY its NanoAdapters (and, for FedDPA-F, a personal
adapter beside them). The backbone is frozen: its tensors never require
grad, and gradients are taken with respect to the adapter tree alone, so the
server-hosted LLM is never perturbed.

``init_client`` builds a client through its strategy's hook;
``init_clients_batched`` builds a cohort of the base hook's clients in cid
order.

Strategy-specific behaviour comes in through the ``repro_torch.strategies``
hooks (``wrap_local_loss``, ``wants_fisher``, ``downloads_global``,
``local_warmup``). ``local_update`` is the sequential engine's path:
download the global adapters, train the personal adapter in its warmup
rounds, run T AdamW steps, then estimate the diagonal FIM (a dedicated pass,
or the squared gradients of the T steps). ``client_ref_like`` gives the
structures a checkpointed client restores into.

``local_update_many`` is the vmap engine's path, the same round for a
cohort of K clients with the same schedule flags. Where the JAX package
``vmap``s the client over a ``lax.scan`` of steps, the port folds the
clients into the batch: their states are stacked (K, ...) on the device,
and each step sends the K·B rows through the frozen backbone once, every
client's rows through its own adapters (``lora_residual_many``), with the
launches of one sequential step. Only the loss mean, the MoE routing
groups and AdamW's clip and bias correction could mix clients, and each is
taken per client. The step differentiates Σₖ of each client's wrapped loss;
the adapter rows are disjoint, so one backward gives every client its own
gradient. It runs in three parts, ``prepare_cohort`` (checks, stacking),
``launch_cohort`` (the update) and ``collect_cohort`` (the losses to the
host once, the rows back into ``ClientState``s).

The sharded engine runs the same layout over a ``("clients",)`` mesh
(``repro_torch.sharding``): ``prepare_cohort(mesh=)`` pads the cohort to a
multiple of the mesh size by repeating the last client's row and cuts each
stacked input into the mesh's row blocks, block d on ``devices[d]``;
``make_many_update(mesh=)`` runs the unchanged update body on each block,
on its own device, so each client's arithmetic is the vmap engine's.
Padding rows compute and are sliced off before any state, metric or byte
leaves this module. ``opt0_override`` and ``batches_override`` take stacks
the engine keeps on the devices across rounds; ``collect_cohort(
with_opt=False)`` and ``collect_cohort_deferred`` leave the stacked outputs
there, and ``loss_metrics_deferred`` brings many chunks' losses to the
host in one copy.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import adapters as adapters_lib
from repro_torch.core.fisher import FisherAccumulator, fisher_pass
from repro_torch.core.types import Batch
from repro_torch.models import model as model_lib
from repro_torch.models.layers import token_accuracy
from repro_torch.optim import adamw_init, adamw_update, adamw_update_many
from repro_torch.sharding import ClientMesh, Sharded, pad_to_multiple, replicate, shard
from repro_torch.utils import tree_leaves, tree_map, tree_stack, tree_unstack


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


def init_client(gen, cfg, cid: int, n_examples: int, strategy) -> ClientState:
    """Build a client via the strategy's ``init_client`` hook."""
    from repro_torch.strategies.base import get_strategy

    return get_strategy(strategy).init_client(gen, cfg, cid, n_examples)


def init_clients_batched(strategy, gen, cfg, cids, n_examples) -> List[ClientState]:
    """A cohort of the base ``Strategy.init_client`` body's clients, drawn
    from ``gen`` in cid order (``repro.core.client.init_clients_batched``)."""
    from repro_torch.strategies.base import Strategy

    if len(n_examples) != len(cids):
        raise ValueError(f"init_clients_batched: {len(cids)} cids but {len(n_examples)} sizes")
    return [Strategy.init_client(strategy, gen, cfg, c, n) for c, n in zip(cids, n_examples)]


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


def _apply_personal(cfg, local_adapters, embeds, enc, use_pallas: bool, clients=None):
    """The personal text adapter on the whole embedding sequence (the image
    prefix included), the personal image adapter on the audio family's
    encoder stream only. ``clients=K``: K stacked personal adapters on the
    folded rows (K·B, ...), client-major."""
    kw = dict(rank=cfg.adapter.rank, alpha=cfg.adapter.alpha, use_pallas=use_pallas,
              clients=clients)
    if "text" in local_adapters:
        embeds = adapters_lib.adapt(local_adapters["text"], embeds, **kw)
    if enc is not None and "image" in local_adapters:
        enc = adapters_lib.adapt(local_adapters["image"], enc, **kw)
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


# ---------------------------------------------------------------------------
# the cohort path (engine="vmap"): K clients folded into the batch
# ---------------------------------------------------------------------------

def cohort_loss(cfg, backbone, adapters, local_adapters, batch: Batch, k: int):
    """``combined_loss`` of K stacked clients in one folded pass -> (losses
    (K,), aux (K,)): adapters (and personal adapters) (K, ...), the batch's
    leaves (K, B, ...)."""
    embeds, positions, labels, mask, enc = adapters_lib.nanoedge_forward(
        cfg, backbone, adapters, batch, clients=k)
    if local_adapters is not None:
        embeds, enc = _apply_personal(cfg, local_adapters, embeds, enc, cfg.use_pallas,
                                      clients=k)
    return model_lib.loss_fn(cfg, backbone, embeds, positions, labels, mask, enc, clients=k)


def cohort_train_step(cfg, strategy, hp: HyperParams, backbone, adapters, opt_state,
                      batch: Batch, global_ref, k: int, local_adapters=None):
    """One AdamW step of K stacked clients -> (adapters, opt_state, losses
    (K,), grads). Client k's wrapped loss gets a base loss that returns its
    term of the folded pass, and its own row of the stacked adapters (so
    FedProx's proximal term reads that row); the step differentiates their
    sum and reports each wrapped loss, as ``train_step`` does."""

    def total(adp):
        losses, aux = cohort_loss(cfg, backbone, adp, local_adapters, batch, k)
        wrapped = [strategy.wrap_local_loss(lambda _, i=i: (losses[i], aux[i]), hp,
                                            global_ref)(row)[0]
                   for i, row in enumerate(tree_unstack(adp, k))]
        wrapped = torch.stack(wrapped)
        return wrapped.sum(), wrapped.detach()

    _, losses, grads = value_and_grad(total, adapters)
    new_adapters, new_opt = adamw_update_many(grads, opt_state, adapters, lr=hp.lr,
                                              weight_decay=hp.weight_decay,
                                              grad_clip=hp.grad_clip)
    return new_adapters, new_opt, losses, grads


def cohort_local_adapter_step(cfg, hp: HyperParams, backbone, adapters, local_adapters,
                              opt_state, batch: Batch, k: int):
    """FedDPA-F's warmup step for K stacked clients: their personal adapters
    train, the shared ones frozen; a personal leaf the loss does not read
    gets a zero gradient. -> (local_adapters, opt_state)."""
    _, _, grads = value_and_grad(
        lambda ladp: (cohort_loss(cfg, backbone, adapters, ladp, batch, k)[0].sum(), None),
        local_adapters, allow_unused=True)
    return adamw_update_many(grads, opt_state, local_adapters, lr=hp.lr,
                             grad_clip=hp.grad_clip)


def cohort_fisher_grad(cfg, backbone, adapters, batch: Batch, k: int):
    """K clients' gradients of the plain task loss, stacked (the dedicated
    FIM pass)."""
    return value_and_grad(
        lambda adp: (cohort_loss(cfg, backbone, adp, None, batch, k)[0].sum(), None),
        adapters)[2]


def make_many_update(cfg, strategy, hp: HyperParams, *, downloads: bool,
                     warmup: bool, mesh: Optional[ClientMesh] = None) -> Callable:
    """The whole round of a stacked cohort, run eagerly (the body the JAX
    package compiles as ``vmap`` over clients of ``lax.scan`` over steps):
    ``update(backbone, global_adapters, adapters0, opt0, local0, lopt0,
    train_xs, warm_xs, fish_xs) -> (adapters, opt, local, lopt, fisher,
    losses (K, T))``, every output stacked on the device. ``*_xs`` are lists
    of batches with (K, B, ...) leaves, one a step (None: no steps);
    ``adapters0`` is None when the cohort downloads the global adapters.

    With ``mesh`` (the JAX package's ``shard_map``): the stacked arguments
    are :class:`~repro_torch.sharding.Sharded` over the mesh, the backbone
    and global adapters :class:`~repro_torch.sharding.Replicated`; block d
    goes through the same body on ``mesh.devices[d]``, and each output is
    ``Sharded`` (None where the body gives None)."""

    def update(backbone, global_adapters, adapters, opt_state, local, lopt, train_xs, warm_xs,
               fish_xs):
        k = opt_state.step.shape[0]
        if downloads:
            adapters = tree_map(lambda g: g.expand(k, *g.shape).clone(), global_adapters)
        if warmup:
            for batch in warm_xs or []:
                local, lopt = cohort_local_adapter_step(cfg, hp, backbone, adapters, local,
                                                        lopt, batch, k)
        acc = FisherAccumulator.init(adapters) if strategy.wants_fisher == "streaming" else None
        losses = []
        for batch in train_xs or []:
            adapters, opt_state, loss, grads = cohort_train_step(
                cfg, strategy, hp, backbone, adapters, opt_state, batch, global_adapters, k,
                local_adapters=local)
            losses.append(loss)
            if acc is not None:
                acc = acc.update(grads)
        fisher = None
        if strategy.wants_fisher == "dedicated":
            # over zero Fisher batches, fisher_pass gives the eps floor (1e-8)
            fisher = fisher_pass(lambda adp, b: cohort_fisher_grad(cfg, backbone, adp, b, k),
                                 adapters, fish_xs or [])
        elif strategy.wants_fisher == "streaming":
            fisher = acc.finalize()
        losses = (torch.stack(losses, dim=1) if losses
                  else torch.zeros((k, 0), dtype=torch.float32, device=opt_state.step.device))
        return adapters, opt_state, local, lopt, fisher, losses

    if mesh is None:
        return update

    def sharded(backbone, global_adapters, *stacks):
        outs = [update(backbone.on(dev), global_adapters.on(dev),
                       *(None if s is None else s.blocks[d] for s in stacks))
                for d, dev in enumerate(mesh.devices)]
        return tuple(None if col[0] is None else Sharded(list(col), mesh) for col in zip(*outs))

    return sharded


def _stack_batch_rows(batch_lists: Sequence[List[Batch]], picks, *, shared: bool, k: int):
    """Per-step cohort batches: a list over steps of batches with (K, B, ...)
    leaves, ``picks(batches)`` giving the batches one client steps through.
    ``shared`` (every client trains on the same list object): each step's
    one batch ``expand``ed to K rows, a view, no copy. None when a client
    has no batches."""
    if shared:
        row = list(picks(batch_lists[0]))
        return [tree_map(lambda x: x.expand(k, *x.shape), b) for b in row] if row else None
    rows = [list(picks(bl)) for bl in batch_lists]
    if any(not row for row in rows):
        return None
    return [tree_stack(step) for step in zip(*rows)]


@dataclass
class PreparedCohort:
    """What :func:`prepare_cohort` hands to :func:`launch_cohort`: the
    cohort's states, its update and its stacked inputs (under a mesh padded
    and cut into the mesh's row blocks). ``k`` counts the real clients."""

    states: List[ClientState]
    k: int
    fn: Callable
    args: tuple                  # (adapters0, opt0, local0, lopt0, train_xs, warm_xs, fish_xs)
    has_local: bool
    warmup: bool
    wants_fisher: Optional[str]
    train_t: int = 0
    mesh: Optional[ClientMesh] = None


@dataclass
class LaunchedCohort:
    """A cohort's update, run: its outputs stacked on the devices (CUDA work
    may still be in flight)."""

    prepared: PreparedCohort
    outs: tuple


def prepare_cohort(cfg, states: List[ClientState], batch_lists: Sequence[List[Batch]],
                   hp: HyperParams, strategy, *, mesh: Optional[ClientMesh] = None,
                   pad_to: Optional[int] = None, opt0_override=None,
                   batches_override=None) -> PreparedCohort:
    """Check and stack a cohort (``repro.core.client.prepare_cohort``): every
    client must have the same download and warmup flags this round (the
    engine groups them so), the same batch shapes, and as many warmup and
    Fisher batches; else ``ValueError`` (use ``engine="sequential"``).

    With ``mesh`` the cohort is padded to ``pad_to`` rows (default: the next
    multiple of the mesh size) by repeating the last client's row, and every
    stacked input is cut into the mesh's row blocks. Padding rows compute and
    are discarded: never returned, merged or counted.

    ``opt0_override`` is the stacked AdamW state itself (already padded and
    placed: last round's output for the same chunk), skipping the stacking;
    the caller owns the invariant that it is these clients' current state.
    ``batches_override`` is an already stacked and placed ``(train_xs,
    warm_xs, fish_xs)`` for this exact cohort: a client's batches never
    change within a run, so the engine reuses them across rounds.
    """
    from repro_torch.strategies.base import get_strategy

    strategy = get_strategy(strategy)
    k = len(states)
    assert k > 0

    participated = [s.rounds_participated for s in states]
    downloads = strategy.downloads_global(participated[0])
    has_local = states[0].local_adapters is not None
    warmup = has_local and strategy.local_warmup(participated[0], hp)
    for s, p in zip(states[1:], participated[1:]):
        if (strategy.downloads_global(p) != downloads
                or (s.local_adapters is not None) != has_local
                or ((s.local_adapters is not None)
                    and strategy.local_warmup(p, hp)) != warmup):
            raise ValueError(
                "local_update_many needs a cohort with uniform download/"
                "warmup schedules; group clients by these flags first")

    if mesh is not None:
        nd = mesh.size
        width = pad_to if pad_to is not None else pad_to_multiple(k, nd)
        if width % nd != 0:
            raise ValueError(f"pad_to={width} must be a multiple of the mesh size {nd}")
        if width < k:
            raise ValueError(f"pad_to={width} is smaller than the cohort ({k})")
        pad = width - k
        states = list(states) + [states[-1]] * pad
        batch_lists = list(batch_lists) + [batch_lists[-1]] * pad
    width = len(states)
    place = (lambda t: t) if mesh is None else (lambda t: None if t is None else shard(t, mesh))

    warm_ts = {min(len(bl), hp.local_steps) for bl in batch_lists} if warmup else {0}
    fish_ts = ({min(len(bl), hp.fisher_batches) for bl in batch_lists}
               if strategy.wants_fisher == "dedicated" else {0})
    if len(warm_ts) > 1 or len(fish_ts) > 1:
        raise ValueError(
            "local_update_many needs uniform per-client batch counts for the "
            "warmup/Fisher passes; use engine='sequential' for ragged shards")
    warm_t, fish_t = warm_ts.pop(), fish_ts.pop()
    train_t = hp.local_steps

    shared = all(bl is batch_lists[0] for bl in batch_lists)
    if batches_override is not None:
        train_xs, warm_xs, fish_xs = batches_override
    else:
        try:
            train_xs = _stack_batch_rows(
                batch_lists, lambda bl: (bl[t % len(bl)] for t in range(train_t)),
                shared=shared, k=width)
            warm_xs = _stack_batch_rows(batch_lists, lambda bl: bl[:warm_t], shared=shared,
                                        k=width) if warmup else None
            fish_xs = _stack_batch_rows(batch_lists, lambda bl: bl[:fish_t], shared=shared,
                                        k=width) if fish_t else None
        except RuntimeError as e:  # torch.stack: shapes differ
            raise ValueError(
                "local_update_many needs identical batch shapes across the "
                f"cohort ({e}); use engine='sequential' for ragged shards") from e
        train_xs, warm_xs, fish_xs = place(train_xs), place(warm_xs), place(fish_xs)
    if train_t > 0 and train_xs is None:
        raise ValueError("clients with no training batches cannot run local steps")

    adapters0 = None if downloads else place(tree_stack([s.adapters for s in states]))
    opt0 = (opt0_override if opt0_override is not None
            else place(tree_stack([s.opt_state for s in states])))
    local0 = place(tree_stack([s.local_adapters for s in states])) if has_local else None
    lopt0 = None
    if warmup:
        lopt0 = place(tree_stack([s.local_opt_state if s.local_opt_state is not None
                                  else adamw_init(s.local_adapters) for s in states]))

    fn = make_many_update(cfg, strategy, hp, downloads=downloads, warmup=warmup, mesh=mesh)
    return PreparedCohort(states=list(states[:k]), k=k, fn=fn,
                          args=(adapters0, opt0, local0, lopt0, train_xs, warm_xs, fish_xs),
                          has_local=has_local, warmup=warmup,
                          wants_fisher=strategy.wants_fisher, train_t=train_t, mesh=mesh)


def launch_cohort(prepared: PreparedCohort, backbone, global_adapters) -> LaunchedCohort:
    """Run a prepared cohort's update. The host queues the whole round's CUDA
    work; nothing here waits for the card. Under a mesh the backbone and
    global adapters are placed on each distinct device, unless the engine
    already placed them (``repro_torch.sharding.replicate``)."""
    if prepared.mesh is not None:
        backbone = replicate(backbone, prepared.mesh)
        global_adapters = replicate(global_adapters, prepared.mesh)
    return LaunchedCohort(prepared=prepared,
                          outs=prepared.fn(backbone, global_adapters, *prepared.args))


def _rows(stack, k: int) -> list:
    """The first ``k`` rows of a stacked output as per-client trees (under a
    mesh on its first device): views of the stack."""
    return stack.rows(k) if isinstance(stack, Sharded) else tree_unstack(stack, k)


def _host_losses(losses, k: int):
    """The first ``k`` rows of a (W, T) losses output as a host array."""
    if isinstance(losses, Sharded):
        losses = losses.gather(k)
    return losses[:k].cpu().numpy()


def collect_cohort(launched: LaunchedCohort, *, with_opt: bool = True,
                   ) -> Tuple[List[ClientState], List[Dict]]:
    """The cohort's (K, T) losses to the host in one copy (one a block under a
    mesh), and each real client's rows back into its ``ClientState`` (views
    of the stacked outputs; under a mesh on its first device). Padding rows
    never leave this function.

    ``with_opt=False`` leaves the AdamW state stacked on the devices: the
    states keep their previous (now stale) ``opt_state``, and the caller
    takes ``launched.outs[1]`` and writes rows back when a client's own value
    is needed (a snapshot, a reshuffled cohort, the end of the run)."""
    p = launched.prepared
    k = p.k
    new_adp, new_opt, new_local, new_lopt, fishers, losses = launched.outs

    adp_list = _rows(new_adp, k)
    opt_list = _rows(new_opt, k) if with_opt else None
    local_list = _rows(new_local, k) if p.has_local else [None] * k
    lopt_list = _rows(new_lopt, k) if p.warmup else [None] * k
    fisher_list = _rows(fishers, k) if p.wants_fisher is not None else [None] * k
    losses_np = _host_losses(losses, k)

    new_states = [dataclasses.replace(
        s, adapters=adp_list[i], opt_state=opt_list[i] if with_opt else s.opt_state,
        local_adapters=local_list[i],
        local_opt_state=lopt_list[i] if p.warmup else s.local_opt_state,
        fisher=fisher_list[i], rounds_participated=s.rounds_participated + 1)
        for i, s in enumerate(p.states)]
    return new_states, _loss_metrics(losses_np)


def collect_cohort_deferred(launched: LaunchedCohort):
    """Collect only the participation counts of a launched cohort; nothing
    leaves the devices. The caller takes ``launched.outs`` (the sharded
    engine keeps them on the devices and folds them into the stacked merge).
    -> (states with their previous, now stale, adapters, AdamW state and
    Fisher; the (W, T) losses still on the devices, or None without local
    steps), the losses for :func:`loss_metrics_deferred`."""
    p = launched.prepared
    new_states = [dataclasses.replace(s, rounds_participated=s.rounds_participated + 1)
                  for s in p.states]
    return new_states, (launched.outs[5] if p.train_t > 0 else None)


def loss_metrics_deferred(loss_arrays, ks) -> List[List[Dict]]:
    """Many chunks' device losses to the host in one copy -> per-chunk metric
    lists (:func:`_loss_metrics`'s arithmetic). ``ks`` holds each chunk's real
    client count; a ``None`` entry (no local steps) gives zero-loss metrics."""
    rows = [(a.gather(k) if isinstance(a, Sharded) else a[:k]) for a, k in zip(loss_arrays, ks)
            if a is not None]
    host = torch.cat([r.to(rows[0].device) for r in rows]).cpu().numpy() if rows else None
    out, at = [], 0
    for a, k in zip(loss_arrays, ks):
        if a is None:
            out.append(_loss_metrics(np.zeros((k, 0), np.float32)))
        else:
            out.append(_loss_metrics(host[at:at + k]))
            at += k
    return out


def _loss_metrics(losses_np) -> List[Dict]:
    """Per-client loss metrics from a (k, T) host array, the sequential
    path's arithmetic: Python floats summed in step order."""
    metrics = []
    for row in losses_np:
        ls = [float(x) for x in row]
        if ls:
            metrics.append({"loss_first": ls[0], "loss_last": ls[-1],
                            "loss_mean": sum(ls) / len(ls)})
        else:
            metrics.append({"loss_first": 0.0, "loss_last": 0.0, "loss_mean": 0.0})
    return metrics


def local_update_many(cfg, backbone, states: List[ClientState],
                      batch_lists: Sequence[List[Batch]], hp: HyperParams, strategy,
                      global_adapters, *, mesh: Optional[ClientMesh] = None,
                      pad_to: Optional[int] = None) -> Tuple[List[ClientState], List[Dict]]:
    """``local_update`` over a cohort of clients with the same schedule flags:
    prepare, launch, collect. ``mesh`` cuts the cohort over a client mesh,
    padded to ``pad_to`` rows (default: the next multiple of the mesh size)."""
    prepared = prepare_cohort(cfg, states, batch_lists, hp, strategy, mesh=mesh, pad_to=pad_to)
    return collect_cohort(launch_cohort(prepared, backbone, global_adapters))


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
