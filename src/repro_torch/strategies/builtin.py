"""FedNano as a registry plugin (``repro.strategies.builtin::FedNano``): a
dedicated diagonal-FIM pass on each client and the Fisher merge of paper
Eq. 1 on the server, batch (``aggregate``) or one upload at a time
(``agg_stream_*``). The other paper strategies are ROADMAP queue 2.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.kernels.fisher_merge import ops as fm_ops
from repro_torch.kernels.fisher_merge import ref as fm_ref
from repro_torch.strategies.base import Strategy, register
from repro_torch.utils import tree_map


def _fisher_fold_tree(num, den, theta, fisher, w: float, *, use_pallas: bool = False):
    """Fold one client's (θ, F, w) into the running f32 num/den trees, in place
    (the JAX package returns new trees). ``use_pallas`` routes each leaf
    through the ``fisher_fold`` kernel, else its plain version. Returns (num, den).
    """
    fold = fm_ops.fisher_fold if use_pallas else fm_ref.fisher_fold
    tree_map(lambda nm, dn, t, f: fold(nm, dn, t, f, w), num, den, theta, fisher)
    return num, den


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

    def agg_stream_finalize(self, acc, *, use_pallas=False, eps: float = 1e-8):
        floor = eps * acc["w"]
        return tree_map(lambda n, d, t: (n / (d + floor)).to(t), acc["num"], acc["den"],
                        acc["like"])
