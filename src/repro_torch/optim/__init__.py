from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update, adamw_update_many
from repro_torch.optim.schedules import constant_schedule, cosine_schedule, linear_warmup_cosine
from repro_torch.optim.sgd import SGDState, sgd_init, sgd_update

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "adamw_update_many",
    "SGDState",
    "sgd_init",
    "sgd_update",
    "constant_schedule",
    "cosine_schedule",
    "linear_warmup_cosine",
    "make_optimizer",
]


def make_optimizer(name: str, **kw):
    """Small factory: returns (init_fn, update_fn) closures."""
    if name == "adamw":
        return (
            lambda params: adamw_init(params),
            lambda grads, state, params, lr: adamw_update(grads, state, params, lr=lr, **kw),
        )
    if name == "sgd":
        return (
            lambda params: sgd_init(params),
            lambda grads, state, params, lr: sgd_update(grads, state, params, lr=lr, **kw),
        )
    raise ValueError(f"unknown optimizer {name!r}")
