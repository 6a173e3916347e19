"""The paper strategies as registry plugins, plus the server-optimizer
variants (``repro.strategies.builtin``): each is a column of paper Tab. 2
written through the ``Strategy`` hooks.

FedNano and FedNano-EF merge with diagonal-Fisher weights (paper Eq. 1),
batch (``aggregate``) or one upload at a time (``agg_stream_*``), on the
``fisher_merge`` and ``fisher_fold`` kernels under ``use_pallas``. The others
take the base FedAvg mean, which the JAX package computes without a kernel.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.kernels.fisher_merge import ops as fm_ops
from repro_torch.kernels.fisher_merge import ref as fm_ref
from repro_torch.strategies.base import Strategy, register, stack_dtypes, weighted_sum_stacks
from repro_torch.utils import tree_add, tree_leaves, tree_map, tree_sq_norm, tree_sub


def _fisher_fold_tree(num, den, theta, fisher, w: float, *, use_pallas: bool = False):
    """Fold one client's (θ, F, w) into the running f32 num/den trees, in place
    (the JAX package returns new trees). ``use_pallas`` folds the whole tree
    in one ``fisher_fold`` kernel launch, else each leaf takes its plain
    version. Returns (num, den).
    """
    fold = fm_ops.fisher_fold_leaves if use_pallas else fm_ref.fisher_fold_leaves
    fold(tree_leaves(num), tree_leaves(den), tree_leaves(theta), tree_leaves(fisher), w)
    return num, den


@register("fedavg")
@dataclass(frozen=True)
class FedAvg(Strategy):
    """Data-size-weighted parameter averaging (McMahan et al. 2017)."""


@register("fedprox")
@dataclass(frozen=True)
class FedProx(FedAvg):
    """FedAvg + (μ/2)·‖θ − θ_global‖² proximal term in the local loss."""

    def wrap_local_loss(self, loss_fn, hp, global_ref):
        def wrapped(adp):
            loss, aux = loss_fn(adp)
            return loss + 0.5 * hp.prox_mu * tree_sq_norm(tree_sub(adp, global_ref)), aux

        return wrapped


@register("fednano")
@dataclass(frozen=True)
class FedNano(Strategy):
    """The paper's method: dedicated diagonal-FIM pass + Fisher merge."""

    wants_fisher: Optional[str] = "dedicated"

    def aggregate(self, thetas, fishers, data_sizes, *, use_pallas=False):
        from repro_torch.core import aggregation

        return aggregation.fisher_merge(thetas, fishers, data_sizes, use_pallas=use_pallas)

    # Streaming Fisher merge: Σ wFθ and Σ wF fold ONE CLIENT AT A TIME into
    # running f32 sums, so no (K, ...) stack ever exists. The weights stay
    # unnormalized, so finalize scales the eps floor by the total weight W:
    # num/(den + eps·W) == (num/W)/((den/W) + eps), the batch formula.
    def agg_stream_fold(self, acc, thetas, fishers, weights, *, use_pallas=False):
        if fishers is None or any(f is None for f in fishers):
            raise ValueError("fednano streaming merge needs a FIM per upload")
        if acc is None:
            zeros = lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device)
            acc = {"num": tree_map(zeros, thetas[0]), "den": tree_map(zeros, thetas[0]),
                   "w": 0.0, "like": tree_map(lambda x: x.dtype, thetas[0])}
        num, den = acc["num"], acc["den"]
        for theta, fisher, w in zip(thetas, fishers, weights):
            num, den = _fisher_fold_tree(num, den, theta, fisher, float(w),
                                         use_pallas=use_pallas)
        return {"num": num, "den": den, "w": acc["w"] + float(sum(float(w) for w in weights)),
                "like": acc["like"]}

    # The stacked fold (sharded engine): Σ wFθ and Σ wF over each chunk's
    # client axis, where the stacks lie, all chunks in one call.
    def agg_stream_fold_stacked(self, acc, theta_stack, fisher_stack, weights, *,
                                use_pallas=False):
        if not isinstance(theta_stack, (list, tuple)):
            theta_stack, fisher_stack, weights = [theta_stack], [fisher_stack], [weights]
        if fisher_stack is None or any(f is None for f in fisher_stack):
            raise ValueError("fednano streaming merge needs a FIM per upload")
        num = weighted_sum_stacks(list(zip(theta_stack, fisher_stack)), weights,
                                  lambda t, f: f.float() * t.float())
        den = weighted_sum_stacks([(f,) for f in fisher_stack], weights, lambda f: f.float())
        wsum = float(sum(float(x) for w in weights for x in w))
        if acc is None:
            return {"num": num, "den": den, "w": wsum, "like": stack_dtypes(theta_stack[0])}
        return {"num": tree_add(acc["num"], num), "den": tree_add(acc["den"], den),
                "w": acc["w"] + wsum, "like": acc["like"]}

    def agg_stream_finalize(self, acc, *, use_pallas=False, eps: float = 1e-8):
        if acc is None:
            return None
        floor = eps * acc["w"]
        return tree_map(lambda n, d, t: (n / (d + floor)).to(t), acc["num"], acc["den"],
                        acc["like"])


@register("fednano_ef")
@dataclass(frozen=True)
class FedNanoEF(FedNano):
    """FedNano with the FIM accumulated from training-step grads (Tab. 7)."""

    wants_fisher: Optional[str] = "streaming"


@register("feddpa_f")
@dataclass(frozen=True)
class FedDPAF(FedAvg):
    """Dual adapters: fedavg the shared one, keep a personal one trained in
    the warmup round(s) only and frozen after."""

    dual_adapters = True

    def local_warmup(self, rounds_participated, hp):
        return rounds_participated < hp.dpa_warmup_rounds

    def eval_params(self, global_adapters, client):
        return global_adapters, client.local_adapters


@register("locft")
@dataclass(frozen=True)
class LocFT(Strategy):
    """Local-only fine-tuning: no merge, no download after round 0."""

    aggregates = False

    def downloads_global(self, rounds_participated):
        return rounds_participated == 0

    def aggregate(self, thetas, fishers, data_sizes, *, use_pallas=False):
        return None

    def eval_params(self, global_adapters, client):
        return client.adapters, None


@register("fedavgm")
@dataclass(frozen=True)
class FedAvgM(FedAvg):
    """FedAvg + server momentum on the round pseudo-gradient (Hsu et al.)."""

    server_lr: float = 1.0
    beta: float = 0.9

    def server_opt(self):
        from repro_torch.strategies.server_opt import FedAvgMOpt

        return FedAvgMOpt(lr=self.server_lr, beta=self.beta)


@register("fedadam")
@dataclass(frozen=True)
class FedAdam(FedAvg):
    """FedAvg + adaptive Adam server step (FedOpt, Reddi et al. 2021)."""

    server_lr: float = 0.1
    b1: float = 0.9
    b2: float = 0.99
    eps: float = 1e-3

    def server_opt(self):
        from repro_torch.strategies.server_opt import FedAdamOpt

        return FedAdamOpt(lr=self.server_lr, b1=self.b1, b2=self.b2, eps=self.eps)
