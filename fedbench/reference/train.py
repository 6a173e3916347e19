"""The plain reference of one FedNano round of a client, and of the server's
Fisher merge (paper Alg. 1 and Eq. 1).

A client downloads the global adapters, takes ``local_steps`` AdamW steps
(global-norm clip, bias correction, no weight decay) on its batches in turn,
each on the mean masked cross entropy of its rows' supervised positions, and
then estimates the diagonal Fisher at its final adapters: the mean over its
first ``fisher_batches`` batches of the squared (unclipped) gradient, plus
1e-8. The server merges θ = Σ p_k F_k θ_k / (Σ p_k F_k + 1e-8), p_k the
client's share of the batches.

Gradients come from autograd through the backbone with each layer under
``torch.utils.checkpoint`` (its input kept in f32, its f32 weights cast again
in the backward), so one layer's f32 copy is alive at a time. A row's
positions after its last supervised one cannot move the loss under the
causal mask, so each batch is cut after the last supervised position of its
rows.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from fedbench.reference import family
from fedbench.reference.precision import F32

ADAM_B1, ADAM_B2, ADAM_EPS, CLIP_EPS, FISHER_EPS = 0.9, 0.999, 1e-8, 1e-9, 1e-8


def _leaves(tree):
    return [tree[m][k] for m in sorted(tree) for k in sorted(tree[m])]


def _like(tree, leaves):
    it = iter(leaves)
    return {m: {k: next(it) for k in sorted(tree[m])} for m in sorted(tree)}


def batch_loss(s, cfg, w, adapters, batch, scale, prec=F32):
    """Mean masked cross entropy of one batch (tokens, labels, mask, patches)."""
    mask = batch["mask"]
    last = int(torch.nonzero(mask.sum(0)).max()) + 1
    tokens, labels, mask = batch["tokens"][:, :last], batch["labels"][:, :last], mask[:, :last]
    patches = batch.get("patches")
    ref = family(cfg)
    x = ref.nanoedge(s, w, adapters, tokens, patches, scale, prec)
    m = 0 if patches is None else patches.shape[1]
    ctx = ref.layer_context(s, cfg, x.shape[1], x.device)
    for lp in w["layers"]:
        x = checkpoint(ref.layer, s, lp, x, ctx, prec, use_reentrant=False)
    rows, cols = torch.nonzero(mask, as_tuple=True)
    logits = ref.head(w, x[rows, m + cols], ctx, prec)
    nll = torch.logsumexp(logits, -1) - logits.gather(-1, labels[rows, cols][:, None])[:, 0]
    return (nll * mask[rows, cols]).sum() / mask.sum().clamp(min=1.0)


def loss_and_grads(s, cfg, w, adapters, batch, scale, prec=F32):
    leaves = [t.detach().requires_grad_(True) for t in _leaves(adapters)]
    loss = batch_loss(s, cfg, w, _like(adapters, leaves), batch, scale, prec)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), list(grads)


def client_round(s, cfg, w, global_adapters, batches, hp: dict, scale, prec=F32):
    """One client's local steps from the global adapters -> dict of its
    losses (T,), final adapters, AdamW moments and each leaf's largest
    gradient norm over the steps."""
    theta = [t.detach().clone() for t in _leaves(global_adapters)]
    mu = [torch.zeros_like(t) for t in theta]
    nu = [torch.zeros_like(t) for t in theta]
    losses, gmax = [], [0.0] * len(theta)
    for step in range(1, hp["local_steps"] + 1):
        batch = batches[(step - 1) % len(batches)]
        loss, g = loss_and_grads(s, cfg, w, _like(global_adapters, theta), batch, scale, prec)
        losses.append(float(loss))
        gmax = [max(a, float(x.norm())) for a, x in zip(gmax, g)]
        gnorm = torch.sqrt(sum(x.square().sum() for x in g))
        clip = torch.clamp(hp["grad_clip"] / (gnorm + CLIP_EPS), max=1.0)
        g = [x * clip for x in g]
        mu = [ADAM_B1 * m + (1 - ADAM_B1) * x for m, x in zip(mu, g)]
        nu = [ADAM_B2 * v + (1 - ADAM_B2) * x.square() for v, x in zip(nu, g)]
        bc1, bc2 = 1 - ADAM_B1 ** step, 1 - ADAM_B2 ** step
        theta = [p - hp["lr"] * (m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS)
                 for p, m, v in zip(theta, mu, nu)]
    like = lambda leaves: _like(global_adapters, leaves)
    return {"losses": losses, "theta": like(theta), "mu": like(mu), "nu": like(nu),
            "grad_max": like([torch.tensor(x) for x in gmax])}


def fisher_at(s, cfg, w, like, theta, batches, hp: dict, scale, prec=F32):
    """The Fisher pass at given adapters ``theta`` (a tree shaped as ``like``)."""
    theta = [t.detach().float() for t in _leaves(theta)]
    fisher = [torch.zeros_like(t) for t in theta]
    fb = batches[: hp["fisher_batches"]]
    for batch in fb:
        _, g = loss_and_grads(s, cfg, w, _like(like, theta), batch, scale, prec)
        fisher = [f + x.square() for f, x in zip(fisher, g)]
    return _like(like, [f / max(len(fb), 1) + FISHER_EPS for f in fisher])


@torch.no_grad()
def first_loss(s, cfg, w, adapters, batch, scale, prec=F32) -> float:
    """The loss of a client's first step, forward only."""
    return float(batch_loss(s, cfg, w, adapters, batch, scale, prec))


def fisher_merge(thetas, fishers, sizes):
    """Eq. 1 in float64 over K clients' adapter trees."""
    total = float(sum(sizes))
    p = [float(n) / total for n in sizes]
    out = {}
    for m in sorted(thetas[0]):
        out[m] = {}
        for k in sorted(thetas[0][m]):
            num = sum(pk * f[m][k].double() * t[m][k].double()
                      for pk, t, f in zip(p, thetas, fishers))
            den = sum(pk * f[m][k].double() for pk, f in zip(p, fishers))
            out[m][k] = num / (den + FISHER_EPS)
    return out
