"""The plain reference of served tokens: one full forward over each sampled
request's prompt and the tokens it was served, teacher-forced, and the gap
by which each served token's logit lies below the reference's best at its
position (0 where the served token is the reference's argmax), in units of
the spread of the reference's logits there. A greedy
server that decodes right serves, at every position, a token within rounding
of the reference's best.

The requests go through the backbone layer by layer together, each layer's
weights cast to f32 once; each request is its own sequence, unpadded.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from fedbench.reference import family
from fedbench.reference.precision import F32, Prec, upcast


@torch.no_grad()
def served_logits(s, cfg, w, requests: List[Dict], scale: float, prec=F32):
    """requests: dicts of ``prompt`` (L,) long, ``served`` (m,) long and
    ``adapter`` (a tenant's adapters or None) -> per request the (m, V)
    logits at the positions that chose the served tokens."""
    ref = family(cfg)
    xs = []
    for r in requests:
        seq = torch.cat([r["prompt"], r["served"][:-1]])[None]
        xs.append(ref.nanoedge(s, w, r["adapter"], seq, None, scale, prec))
    ctxs = [ref.layer_context(s, cfg, x.shape[1], x.device) for x in xs]
    for lp in w["layers"]:
        lp32 = upcast(lp)
        xs = [ref.layer(s, lp32, x, ctx, prec) for x, ctx in zip(xs, ctxs)]
    out = []
    for r, x, ctx in zip(requests, xs, ctxs):
        L = r["prompt"].shape[0]
        out.append(ref.head(w, x[0, L - 1:], ctx, prec))
    return out


def gaps(logits, tokens) -> torch.Tensor:
    """(max logit - logit of ``tokens``) over the logits' standard deviation
    across the vocabulary, at each position (m,): in units of the logits'
    own spread, so that one limit reads alike at any width."""
    gap = logits.max(-1).values - logits.gather(-1, tokens[:, None])[:, 0]
    return gap / logits.std(-1)


def widest_gap(s, cfg, w, requests, scale, control: Optional[Prec] = None):
    """The widest gap of the served tokens under the f32 reference; with
    ``control``, instead of the served tokens the ones that the control's
    precision puts first at each position."""
    ref_logits = served_logits(s, cfg, w, requests, scale)
    if control is None:
        return max(float(gaps(lg, r["served"]).max()) for lg, r in zip(ref_logits, requests))
    low = served_logits(s, cfg, w, requests, scale, control)
    return max(float(gaps(lg, lo.argmax(-1)).max()) for lg, lo in zip(ref_logits, low))
