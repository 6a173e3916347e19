"""Strategy plugin API of the port (``repro.strategies.base``): the hooks a
federated method implements.

    init_client        build the per-client state (dual adapters, AdamW state)
    init_clients       the same for a cohort, client after client
    wrap_local_loss    modify the local objective (FedProx's prox term)
    wants_fisher       None | "dedicated" | "streaming" FIM estimation
    post_local_update  what the client hands to the upload transforms
    aggregate          merge the uploads into the new global adapters
    agg_stream_*       the same merge folded one chunk of uploads at a time
    eval_params        which (shared, personal) params a client evaluates

plus the scheduling predicates ``downloads_global`` and ``local_warmup``,
the flags ``dual_adapters`` and ``aggregates``, and an optional
``server_opt`` factory. Strategies are frozen dataclasses, registered by
name with ``@register`` and resolved with ``get_strategy``, which passes
instances through. ``checkpoint_meta`` is the identity a RunState records
and a resume checks. ``agg_stream_fold_stacked`` is the sharded engine's
fold of already stacked (K, ...) uploads, where they lie.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Type, Union

import torch

from repro_torch.sharding import Sharded
from repro_torch.utils import tree_add, tree_leaves, tree_map, tree_weighted_sum

_REGISTRY: Dict[str, Type["Strategy"]] = {}


def weighted_sum_stacks(stacks, weights, fn):
    """Σ over chunks of Σ_rows w·fn(rows), leaf by leaf: an f32 ``tensordot``
    of each chunk's weights over its client axis (the JAX package's
    ``jnp.tensordot(w, ., axes=1)``), added to the running sum chunk by chunk.
    ``stacks`` holds per chunk a tuple of stacked trees of one structure; a
    chunk of :class:`~repro_torch.sharding.Sharded` trees is reduced block by
    block where each block lives, and its D partial sums are added to the
    running sum on the mesh's first device in shard order (so a mesh whose
    blocks are one client wide sums in the order of chunks one client wide)."""
    total = None

    def add(contrib):
        nonlocal total
        total = contrib if total is None else tree_add(total, contrib)

    for trees, w in zip(stacks, weights):
        w = torch.tensor([float(x) for x in w], dtype=torch.float32)
        if isinstance(trees[0], Sharded):
            mesh, bw = trees[0].mesh, trees[0].block_width
            for d, dev in enumerate(mesh.devices):
                wd = w[d * bw:(d + 1) * bw].to(dev)
                add(tree_map(lambda *xs: torch.tensordot(wd, fn(*xs), dims=1).to(
                    mesh.devices[0]), *(t.blocks[d] for t in trees)))
        else:
            wd = w.to(tree_leaves(trees[0])[0].device)
            add(tree_map(lambda *xs: torch.tensordot(wd, fn(*xs), dims=1), *trees))
    return total


def stack_dtypes(stack):
    """The leaf dtypes of a stacked (or Sharded) upload tree."""
    return tree_map(lambda x: x.dtype, stack.blocks[0] if isinstance(stack, Sharded) else stack)


def register(name: str) -> Callable[[Type["Strategy"]], Type["Strategy"]]:
    def deco(cls: Type["Strategy"]) -> Type["Strategy"]:
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def available_strategies() -> Tuple[str, ...]:
    """Sorted names of every registered strategy."""
    import repro_torch.strategies.builtin  # noqa: F401  (registers the built-ins)

    return tuple(sorted(_REGISTRY))


def get_strategy(spec: Union[str, "Strategy"]) -> "Strategy":
    """Resolve a strategy name (or pass an instance through)."""
    if isinstance(spec, Strategy):
        return spec
    if not isinstance(spec, str):
        raise TypeError(f"strategy must be a name or Strategy instance, got {type(spec)}")
    import repro_torch.strategies.builtin  # noqa: F401  (registers the built-ins)

    if spec not in _REGISTRY:
        raise ValueError(f"unknown strategy {spec!r}; registered strategies: "
                         f"{', '.join(sorted(_REGISTRY))}")
    return _REGISTRY[spec]()


@dataclass(frozen=True)
class Strategy:
    """Base strategy: FedAvg-shaped defaults, every hook overridable."""

    name = "strategy"            # overwritten by @register
    dual_adapters = False        # keep a personal adapter next to the shared one
    aggregates = True            # False: the server never merges (local-only)
    wants_fisher: Optional[str] = None  # None | "dedicated" | "streaming"

    # -- client lifecycle ---------------------------------------------------
    def init_client(self, gen, cfg, cid: int, n_examples: int):
        """Fresh client: adapters (and the personal adapter under
        ``dual_adapters``) drawn from ``gen``, zero AdamW state."""
        from repro_torch.core import adapters as adapters_lib
        from repro_torch.core.client import ClientState
        from repro_torch.optim import adamw_init

        adp = adapters_lib.init_nanoedge(gen, cfg)
        local = adapters_lib.init_nanoedge(gen, cfg) if self.dual_adapters else None
        return ClientState(cid=cid, adapters=adp, opt_state=adamw_init(adp),
                           n_examples=n_examples, local_adapters=local)

    def init_clients(self, gen, cfg, cids, n_examples):
        """A cohort's clients: the ``init_client`` calls in cid order, each
        drawing from ``gen`` in turn."""
        return [self.init_client(gen, cfg, cid, n) for cid, n in zip(cids, n_examples)]

    def downloads_global(self, rounds_participated: int) -> bool:
        """Whether the client adopts θ_global at the start of this round
        (``rounds_participated`` counts the client's own earlier rounds)."""
        return True

    def local_warmup(self, rounds_participated: int, hp) -> bool:
        """Whether this round trains the personal adapter before the local steps."""
        return False

    # -- local objective ----------------------------------------------------
    def wrap_local_loss(self, loss_fn: Callable, hp, global_ref) -> Callable:
        """Wrap the (adapters -> (loss, aux)) objective."""
        return loss_fn

    # -- upload -------------------------------------------------------------
    def post_local_update(self, state, global_adapters, round_idx: int):
        """What the client hands to the upload transforms."""
        return state.adapters

    # -- server -------------------------------------------------------------
    def aggregate(self, thetas: List, fishers: Optional[List], data_sizes: Sequence[int], *,
                  use_pallas: bool = False):
        from repro_torch.core import aggregation

        return aggregation.fedavg(thetas, data_sizes)

    # The O(chunk)-memory counterpart of ``aggregate``: the engine folds chunks
    # of uploads into a running accumulator. The base is the running weighted
    # average (fedavg up to summation order); Fisher-merging strategies
    # override all three with a numerator/denominator pair.
    def agg_stream_init(self):
        """Fresh streaming accumulator (None: shaped on the first fold)."""
        return None

    def agg_stream_fold(self, acc, thetas: List, fishers: Optional[List],
                        weights: Sequence[float], *, use_pallas: bool = False):
        """Fold one chunk of uploads; ``weights`` are unnormalized (data
        sizes), normalized once in ``agg_stream_finalize``."""
        num = tree_weighted_sum(thetas, weights)
        w = float(sum(weights))
        if acc is None:
            return {"num": num, "w": w, "like": tree_map(lambda x: x.dtype, thetas[0])}
        return {"num": tree_add(acc["num"], num), "w": acc["w"] + w, "like": acc["like"]}

    def agg_stream_fold_stacked(self, acc, theta_stack, fisher_stack,
                                weights: Sequence[float], *, use_pallas: bool = False):
        """Fold already stacked (K, ...) uploads: the sharded engine's fold of
        its outputs where they lie, padding rows masked by zero weights (a
        zero-weight row adds nothing). ``theta_stack``, ``fisher_stack`` and
        ``weights`` may each be a list of per-chunk values, folded in one
        call. The accumulator is ``agg_stream_fold``'s; the two folds differ
        only in f32 summation order."""
        if not isinstance(theta_stack, (list, tuple)):
            theta_stack, weights = [theta_stack], [weights]
        num = weighted_sum_stacks([(t,) for t in theta_stack], weights, lambda t: t.float())
        wsum = float(sum(float(x) for w in weights for x in w))
        if acc is None:
            return {"num": num, "w": wsum, "like": stack_dtypes(theta_stack[0])}
        return {"num": tree_add(acc["num"], num), "w": acc["w"] + wsum, "like": acc["like"]}

    def agg_stream_finalize(self, acc, *, use_pallas: bool = False):
        """The merged adapters (None if nothing was folded)."""
        if acc is None:
            return None
        inv = 1.0 / max(acc["w"], 1e-12)
        return tree_map(lambda n, d: (n * inv).to(d), acc["num"], acc["like"])

    def server_opt(self):
        """Optional ServerOpt applied to the merged result (None = identity)."""
        return None

    # -- checkpointing ------------------------------------------------------
    # A strategy is a frozen dataclass with no state of its own: the streaming
    # accumulators live within one round, and what it carries across rounds
    # sits in ClientState or a transform's state, both of which a RunState
    # keeps. So a snapshot records only this identity.
    def checkpoint_meta(self) -> Dict[str, Any]:
        """Identity written into RunState meta and checked on resume, so a
        checkpoint of one method never resumes as another."""
        return {"name": self.name, "wants_fisher": self.wants_fisher,
                "dual_adapters": self.dual_adapters, "aggregates": self.aggregates}

    # -- evaluation ---------------------------------------------------------
    def eval_params(self, global_adapters, client) -> Tuple[Any, Optional[Any]]:
        """(shared adapters, personal adapters) this client evaluates with."""
        return global_adapters, None

