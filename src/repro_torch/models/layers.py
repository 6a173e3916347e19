"""Core layers of the port (PyTorch counterpart of ``repro.models.layers``).

Parameters are plain dicts of tensors, laid out as in the JAX package
(projections are ``(in, out)`` and applied as ``x @ w``), so the two
packages exchange weights through ``repro_torch.interop`` without
transposes. Every initializer draws from an explicit ``torch.Generator``
on the target device (on ``meta``, a :class:`MetaGenerator`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (config dtypes are strings)."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

class MetaGenerator:
    """Stands in for a ``torch.Generator`` on the meta device, which has none:
    the launch layer's abstract inputs (``launch/steps.py``) run the real
    initializers there, allocating nothing and drawing no value."""

    device = torch.device("meta")


def make_generator(device, seed: int):
    """A generator seeded with ``seed`` on ``device`` (a :class:`MetaGenerator`
    on ``meta``)."""
    if torch.device(device).type == "meta":
        return MetaGenerator()
    return torch.Generator(device=device).manual_seed(seed)


def _draw(fn, gen, shape):
    real = gen if isinstance(gen, torch.Generator) else None
    return fn(shape, generator=real, device=gen.device, dtype=torch.float32)


def uniform(gen, shape):
    """U[0, 1) in f32 on the generator's device."""
    return _draw(torch.rand, gen, shape)


def normal(gen, shape):
    """N(0, 1) in f32 on the generator's device."""
    return _draw(torch.randn, gen, shape)


def dense_init(gen: torch.Generator, shape, dtype=torch.float32, scale=None):
    """Truncated-normal (within ±2σ) fan-in init, drawn by the inverse CDF."""
    if isinstance(gen, MetaGenerator):  # no values to transform: the leaf's shape and dtype
        return torch.empty(shape, dtype=dtype, device=gen.device)
    fan_in = shape[0] if len(shape) >= 2 else max(shape[-1], 1)
    std = scale if scale is not None else fan_in ** -0.5
    lo, hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2, (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2
    u = uniform(gen, shape)
    z = torch.erfinv((lo + u * (hi - lo)) * 2.0 - 1.0) * math.sqrt(2.0)
    return (z.clamp_(-2.0, 2.0) * std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.float32):
    if isinstance(gen, MetaGenerator):
        return torch.empty(shape, dtype=dtype, device=gen.device)
    return (normal(gen, shape) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms / MLP / embeddings
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps: float = 1e-6):
    """RMSNorm in f32 inside, cast back to the activation dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * params["scale"].float()).to(x.dtype)


def init_layernorm(d: int, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(params, x, eps: float = 1e-5):
    """LayerNorm in f32 inside, cast back to the activation dtype
    (``layers.py:54-61``)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    return (xf * params["scale"].float() + params["bias"].float()).to(x.dtype)


def init_norm(cfg, d: int, dtype, device):
    """The config's norm: LayerNorm (scale and bias) or RMSNorm (scale)."""
    if cfg.norm == "layernorm":
        return init_layernorm(d, dtype, device)
    return init_rmsnorm(d, dtype, device)


def norm(cfg, params, x):
    return layernorm(params, x) if cfg.norm == "layernorm" else rmsnorm(params, x)


def init_mlp(gen, cfg, dtype, d_ff=None):
    """SwiGLU's or GeGLU's three projections, or GELU's two (no ``w_gate``);
    ``d_ff`` overrides the config's width (the MoE shared expert,
    ``layers.py:76-89``)."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p = {"w_gate": dense_init(gen, (d, f), dtype)} if cfg.act in ("swiglu", "geglu") else {}
    p["w_up"] = dense_init(gen, (d, f), dtype)
    p["w_down"] = dense_init(gen, (f, d), dtype)
    return p


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation; the exact erf form
    differs by up to 4.7e-4."""
    return F.gelu(x, approximate="tanh")


def mlp(cfg, params, x):
    """Position-wise MLP: SwiGLU (silu(x·Wg) ⊙ x·Wu)·Wd, GeGLU
    (gelu(x·Wg) ⊙ x·Wu)·Wd, or GELU gelu(x·Wu)·Wd (``layers.py:92-104``)."""
    if cfg.act == "swiglu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    elif cfg.act == "geglu":
        h = gelu(x @ params["w_gate"]) * (x @ params["w_up"])
    else:
        h = gelu(x @ params["w_up"])
    return h @ params["w_down"]


def init_embedding(gen, vocab: int, d: int, dtype):
    return {"table": embed_init(gen, (vocab, d), dtype)}


def embed(params, tokens):
    return params["table"][tokens]


def unembed(params, x):
    """Project back to vocab."""
    return x @ params["table"].t().to(x.dtype)


def init_learned_pos(gen, max_len: int, d: int, dtype):
    return {"pos": embed_init(gen, (max_len, d), dtype)}


# ---------------------------------------------------------------------------
# losses (f32, as the JAX package computes them)
# ---------------------------------------------------------------------------

def lm_loss(logits, labels, mask, clients=None):
    """Masked next-token cross entropy.

    logits (B, S, V), already shifted (logits[t] predicts labels[t]);
    labels (B, S) int; mask (B, S) {0, 1}, 1 on supervised (answer) positions.
    ``clients=K``: the B rows are K clients' blocks of B/K, and the loss is
    (K,), each client's masked sum over its own mask count.
    """
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = (logz - gold) * mask
    if clients is None:
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return (nll.reshape(clients, -1).sum(1)
            / torch.clamp(mask.reshape(clients, -1).sum(1), min=1.0))


def _chunk_nll(h, table, labels, mask, clients):
    """One chunk's unembed and masked CE -> (Σ nll, Σ mask), per client with
    ``clients``; the (rows, chunk, V) f32 logits die inside."""
    lg = (h @ table.t().to(h.dtype)).float()
    gold = torch.gather(lg, -1, labels[..., None].long())[..., 0]
    nll = (torch.logsumexp(lg, dim=-1) - gold) * mask
    if clients is None:
        return nll.sum(), mask.sum()
    return nll.reshape(clients, -1).sum(1), mask.reshape(clients, -1).sum(1)


def chunked_lm_loss(hidden, table, labels, mask, *, chunk: int, clients=None):
    """Fused unembed + masked CE over sequence chunks (``layers.py:147-180``):
    the full (B, S, V) logits are never formed.

    hidden (B, S, D); table (V, D); labels, mask (B, S). Each chunk runs
    under ``torch.utils.checkpoint`` (non-reentrant), the counterpart of the
    JAX body's ``@jax.checkpoint``: the backward recomputes the chunk's
    logits, so no (B, chunk, V) f32 logits survive the forward. The sequence
    is padded with zero rows, label 0 and mask 0 to a multiple of
    ``chunk``. ``clients=K``: the B rows are K clients' blocks and the loss
    is (K,), each client's masked sum over its own mask count, as JAX's
    ``vmap`` of this function gives.
    """
    B, S, _ = hidden.shape
    pad = (-S) % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    total = denom = 0.0
    for start in range(0, S + pad, chunk):
        sl = slice(start, start + chunk)
        nll, m = checkpoint(_chunk_nll, hidden[:, sl], table, labels[:, sl], mask[:, sl],
                            clients, use_reentrant=False)
        total, denom = total + nll, denom + m
    return total / torch.clamp(denom, min=1.0)


def token_accuracy(logits, labels, mask):
    pred = torch.argmax(logits, dim=-1)
    correct = (pred == labels).float() * mask
    return correct.sum() / torch.clamp(mask.sum(), min=1.0)
