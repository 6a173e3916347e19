"""Core layers of the port (PyTorch counterpart of ``repro.models.layers``).

Parameters are plain dicts of tensors, laid out as in the JAX package
(projections are ``(in, out)`` and applied as ``x @ w``), so the two
packages exchange weights through ``repro_torch.interop`` without
transposes. Every initializer draws from an explicit ``torch.Generator``
on the target device.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (config dtypes are strings)."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, dtype=torch.float32, scale=None):
    """Truncated-normal (within ±2σ) fan-in init, drawn by the inverse CDF."""
    fan_in = shape[0] if len(shape) >= 2 else max(shape[-1], 1)
    std = scale if scale is not None else fan_in ** -0.5
    lo, hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2, (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2
    u = torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32)
    z = torch.erfinv((lo + u * (hi - lo)) * 2.0 - 1.0) * math.sqrt(2.0)
    return (z.clamp_(-2.0, 2.0) * std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.float32):
    z = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (z * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norm / MLP / embeddings
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps: float = 1e-6):
    """RMSNorm in f32 inside, cast back to the activation dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * params["scale"].float()).to(x.dtype)


def init_mlp(gen, cfg, dtype):
    if cfg.act != "swiglu":
        raise NotImplementedError(f"act={cfg.act!r}: the port runs swiglu only "
                                  "(other activations: ROADMAP queue 3)")
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": dense_init(gen, (d, f), dtype),
        "w_up": dense_init(gen, (d, f), dtype),
        "w_down": dense_init(gen, (f, d), dtype),
    }


def mlp(cfg, params, x):
    """SwiGLU position-wise MLP: (silu(x·Wg) ⊙ x·Wu)·Wd."""
    h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]


def init_embedding(gen, vocab: int, d: int, dtype):
    return {"table": embed_init(gen, (vocab, d), dtype)}


def embed(params, tokens):
    return params["table"][tokens]


def unembed(params, x):
    """Project back to vocab."""
    return x @ params["table"].t().to(x.dtype)


# ---------------------------------------------------------------------------
# losses (f32, as the JAX package computes them)
# ---------------------------------------------------------------------------

def lm_loss(logits, labels, mask):
    """Masked next-token cross entropy.

    logits (B, S, V), already shifted (logits[t] predicts labels[t]);
    labels (B, S) int; mask (B, S) {0, 1}, 1 on supervised (answer) positions.
    """
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


def token_accuracy(logits, labels, mask):
    pred = torch.argmax(logits, dim=-1)
    correct = (pred == labels).float() * mask
    return correct.sum() / torch.clamp(mask.sum(), min=1.0)
