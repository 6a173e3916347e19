"""Strategy plugin API of the port (``repro.strategies.base``): the hooks a
federated method implements, cut to those FedNano's sequential round uses.

    init_client        build the per-client state (adapters, AdamW state)
    wrap_local_loss    modify the local objective (identity here)
    wants_fisher       None | "dedicated" FIM estimation
    post_local_update  what the client uploads after its local steps
    aggregate          merge the uploads into the new global adapters
    agg_stream_*       the same merge folded one upload at a time
    eval_params        which (shared, personal) params a client evaluates

Strategies are frozen dataclasses, registered by name with ``@register``
and resolved with ``get_strategy``. Only ``fednano`` is ported; the JAX
package's other strategies raise ``NotImplementedError`` (ROADMAP queue 2).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, Type, Union

_REGISTRY: Dict[str, Type["Strategy"]] = {}

# registered in the JAX package, not yet in the port
NOT_PORTED = ("fednano_ef", "fedavg", "fedprox", "feddpa_f", "locft", "fedavgm",
              "fedadam")


def register(name: str) -> Callable[[Type["Strategy"]], Type["Strategy"]]:
    def deco(cls: Type["Strategy"]) -> Type["Strategy"]:
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def get_strategy(spec: Union[str, "Strategy"]) -> "Strategy":
    """Resolve a strategy name (or pass an instance through)."""
    if isinstance(spec, Strategy):
        return spec
    if not isinstance(spec, str):
        raise TypeError(f"strategy must be a name or Strategy instance, got {type(spec)}")
    import repro_torch.strategies.builtin  # noqa: F401  (registers the built-ins)

    if spec in _REGISTRY:
        return _REGISTRY[spec]()
    if spec in NOT_PORTED:
        raise NotImplementedError(f"strategy {spec!r}: the port runs {sorted(_REGISTRY)}; "
                                  "the others are ROADMAP queue 2")
    raise ValueError(f"unknown strategy {spec!r}; registered strategies: "
                     f"{', '.join(sorted(_REGISTRY))}")


@dataclass(frozen=True)
class Strategy:
    """Base strategy; every hook overridable."""

    name = "strategy"            # overwritten by @register
    wants_fisher: Optional[str] = None  # None | "dedicated"

    def init_client(self, gen, cfg, cid: int, n_examples: int):
        """Fresh client: adapters drawn from ``gen``, zero AdamW state."""
        from repro_torch.core import adapters as adapters_lib
        from repro_torch.core.client import ClientState
        from repro_torch.optim import adamw_init

        adp = adapters_lib.init_nanoedge(gen, cfg)
        return ClientState(cid=cid, adapters=adp, opt_state=adamw_init(adp),
                           n_examples=n_examples)

    def downloads_global(self, rounds_participated: int) -> bool:
        """Whether the client adopts θ_global at the start of this round."""
        return True

    def wrap_local_loss(self, loss_fn: Callable, hp, global_ref) -> Callable:
        """Wrap the (adapters -> (loss, aux)) objective."""
        return loss_fn

    def post_local_update(self, state, global_adapters, round_idx: int):
        """What the client uploads."""
        return state.adapters

    def aggregate(self, thetas, fishers, data_sizes, *, use_pallas: bool = False):
        raise NotImplementedError(f"{self.name}: FedAvg aggregation is ROADMAP queue 2")

    def agg_stream_init(self):
        """Fresh streaming accumulator (None: shaped on the first fold)."""
        return None

    def agg_stream_fold(self, acc, thetas, fishers, weights, *, use_pallas: bool = False):
        raise NotImplementedError(f"{self.name}: streaming FedAvg is ROADMAP queue 2")

    def agg_stream_finalize(self, acc, *, use_pallas: bool = False):
        raise NotImplementedError(f"{self.name}: streaming FedAvg is ROADMAP queue 2")

    def eval_params(self, global_adapters, client) -> Tuple[Any, Optional[Any]]:
        """(shared adapters, personal adapters) this client evaluates with."""
        return global_adapters, None
