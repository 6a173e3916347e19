"""Mixture-of-Experts layer of the port (PyTorch counterpart of ``repro.models.moe``).

The JAX package's GShard-style dense dispatch, kept as it is: tokens are
split into groups of ``G``; each token picks its top-k experts by router
probability; each expert takes at most ``C`` tokens of a group, ranked
choice-major (every top-1 pick before any top-2 pick, earlier tokens first
within a choice), and the rest are dropped; dispatch and combine are dense
one-hot products of size tokens × E × C. Every expert therefore reads its
weights on every call. The JAX package has no Pallas kernel here, and this
is plain PyTorch with the same arithmetic and casts; its ``constrain``
sharding hints change no number and have no counterpart.

``route`` makes the routing decisions and ``moe_apply`` looks it up at
every call, so a caller that counts the dropped choices or compares two
runs' routing wraps ``moe.route`` (as the tests and ``chip_smoke.py`` do);
the main path records nothing.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, gelu, init_mlp, mlp


class Routing(NamedTuple):
    probs: torch.Tensor   # (g, G, E) router probabilities, f32
    gates: torch.Tensor   # (g, G, K) renormalised top-k probabilities
    idx: torch.Tensor     # (g, G, K) chosen experts
    keep: torch.Tensor    # (g, G, K) bool: the choice took a slot
    slot: torch.Tensor    # (g, G, K) its rank within the expert (a slot where kept)
    capacity: int


def _group_size(tokens: int, target: int = 512) -> int:
    """The largest divisor of ``tokens`` that is at most ``target``
    (``moe.py:23-31``): a count above 512 that 512 does not divide gets a
    smaller group, and a prime one above 512 gets groups of 1."""
    if tokens <= target:
        return tokens
    if tokens % target == 0:
        return target
    g = target
    while g > 1 and tokens % g != 0:
        g -= 1
    return g


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def capacity(cfg, group: int) -> int:
    """Slots per expert per group (``moe.py:61-62``). ``int(q + 0.999)`` is
    not ``ceil``: a quotient within 0.001 above an integer rounds down."""
    mcfg = cfg.moe
    c = max(1, _round_up(int(group * mcfg.top_k * mcfg.capacity_factor / mcfg.n_experts
                             + 0.999), 4))
    return min(c, group * mcfg.top_k)


def init_moe(gen, cfg, dtype):
    """Router (d, E) in f32 whatever the backbone's dtype; expert weights
    (E, d, f) and (E, f, d), ``w_gate`` included under GELU, though
    ``moe_apply`` never reads it there (``moe.py:34-47``); the shared
    expert's MLP where the config has one."""
    mcfg = cfg.moe
    d, f, E = cfg.d_model, cfg.d_ff, mcfg.n_experts
    p = {
        "router": dense_init(gen, (d, E), torch.float32),
        "w_gate": dense_init(gen, (E, d, f), dtype),
        "w_up": dense_init(gen, (E, d, f), dtype),
        "w_down": dense_init(gen, (E, f, d), dtype, scale=f ** -0.5),
    }
    if mcfg.shared_d_ff:
        p["shared"] = init_mlp(gen, cfg, dtype, d_ff=mcfg.shared_d_ff)
    return p


def route(cfg, router, xg) -> Routing:
    """Top-k experts of grouped tokens xg (g, G, D) and their slots
    (``moe.py:64-85``): choice-major ranks within each expert, the picks of
    earlier choices (all tokens) before earlier tokens of the same choice."""
    mcfg = cfg.moe
    E, K = mcfg.n_experts, mcfg.top_k
    C = capacity(cfg, xg.shape[1])
    # in the router's dtype: f32 in a bf16 or f32 backbone (``moe.py:67``)
    logits = torch.einsum("gtd,de->gte", xg.to(router.dtype), router)
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k: the larger first, the lower index first on ties
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = order.values[..., :K], order.indices[..., :K]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    oh = F.one_hot(idx, E).float()                                # (g, G, K, E)
    counts = oh.sum(dim=1)                                        # (g, K, E)
    prev_choice = torch.cumsum(counts, dim=1) - counts
    within = torch.cumsum(oh, dim=1) - oh
    slot = ((within + prev_choice[:, None]) * oh).sum(-1).long()  # (g, G, K)
    return Routing(probs, gates, idx, slot < C, slot, C)


def moe_apply(cfg, params, x, group: Optional[int] = None, clients: Optional[int] = None):
    """x (B, S, D) -> (y (B, S, D), balance loss scalar f32) (``moe.py:50-114``).

    The B·S tokens route in groups of ``group`` (default ``_group_size``).
    The decode step passes 1, so that each row routes alone, as under the
    JAX engine's ``vmap`` over its pages. ``clients=K``: the B rows are K
    clients' blocks, so the default group is ``_group_size`` of one client's
    tokens (a group never straddles two clients, and capacity drops are
    those of JAX's ``vmap`` over clients), and the balance loss is (K,), each
    client's mean over its own groups.
    """
    E = cfg.moe.n_experts
    B, S, D = x.shape
    xg = x.reshape(-1, group or _group_size(B * S // (clients or 1)), D)
    r = route(cfg, params["router"], xg)

    oh = F.one_hot(r.idx, E).float()                              # (g, G, K, E)
    pos_oh = F.one_hot(torch.clamp(r.slot, max=r.capacity - 1), r.capacity).float()
    disp_k = oh[..., None] * pos_oh[..., None, :] * r.keep.float()[..., None, None]
    dispatch = disp_k.sum(2)                                      # (g, G, E, C)
    combine = (disp_k * r.gates[..., None, None]).sum(2)

    xe = torch.einsum("gtec,gtd->egcd", dispatch.to(x.dtype), xg)  # (E, g, C, D)
    if cfg.act == "swiglu":
        h = (F.silu(torch.einsum("egcd,edf->egcf", xe, params["w_gate"]))
             * torch.einsum("egcd,edf->egcf", xe, params["w_up"]))
    else:
        h = gelu(torch.einsum("egcd,edf->egcf", xe, params["w_up"]))
    eo = torch.einsum("egcf,efd->egcd", h, params["w_down"])
    y = torch.einsum("gtec,egcd->gtd", combine.to(x.dtype), eo).reshape(B, S, D)

    if "shared" in params:
        y = y + mlp(cfg, params["shared"], x)

    # GShard balance loss: reported only, the backbone is frozen under FedNano
    frac_tokens = oh[:, :, 0, :].mean(dim=1)                      # (g, E)
    lb = E * (frac_tokens * r.probs.mean(dim=1)).sum(-1)          # (g,)
    return y, (lb.mean() if clients is None else lb.reshape(clients, -1).mean(1))
