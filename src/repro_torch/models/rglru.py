"""RG-LRU recurrent block of the port (PyTorch counterpart of ``repro.models.rglru``;
Griffin / RecurrentGemma, arXiv:2402.19427).

Recurrence, per channel:
    r_t = sigmoid(W_a x_t + b_a)            recurrence gate
    i_t = sigmoid(W_x x_t + b_x)            input gate
    a_t = exp(-c · softplus(Λ) · r_t)       c = 8
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

Block layout (Griffin's recurrent block):
    u -> [branch A: linear -> GeLU] ⊙ [branch B: linear -> conv1d -> RG-LRU] -> linear

The JAX package has no kernel here: training and prefill run the linear
recurrence as ``jax.lax.associative_scan``. The port runs it as a
Hillis–Steele scan over the sequence axis, log2(S) rounds of whole-tensor
products (``_linear_scan``), plain PyTorch. Its order of association differs
from ``associative_scan``'s, so the two agree to f32 rounding, not bit for
bit. Decode is the O(1) step. The gates are f32 inside, whatever the
backbone's dtype; ``b_a``, ``b_x`` and ``lam`` are stored in f32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.layers import dense_init, gelu, normal, uniform

_C = 8.0


class RGLRUState(NamedTuple):
    conv: torch.Tensor  # (B, conv_width-1, d_rnn): trailing pre-conv window, model dtype
    h: torch.Tensor     # (B, d_rnn) f32


def _d_rnn(cfg) -> int:
    return cfg.rglru.d_rnn or cfg.d_model


def init_rglru(gen, cfg, dtype):
    """Random block params from a seeded generator, the JAX package's leaves
    (``rglru.py:37-56``): Λ is drawn so that a ∈ (0.9, 0.999) at r = 1."""
    d, dr, cw = cfg.d_model, _d_rnn(cfg), cfg.rglru.conv_width
    dev = gen.device
    u = uniform(gen, (dr,))
    lam = 0.9 ** 2 + u * (0.999 ** 2 - 0.9 ** 2)
    lam = torch.log(torch.expm1(-torch.log(lam) / (2 * _C)))  # inverse of a = exp(-c softplus(Λ))
    conv_w = normal(gen, (cw, dr))
    return {
        "w_gate_branch": dense_init(gen, (d, dr), dtype),
        "w_rec_branch": dense_init(gen, (d, dr), dtype),
        "conv_w": (conv_w * 0.1).to(dtype),
        "conv_b": torch.zeros((dr,), dtype=dtype, device=dev),
        "w_a": dense_init(gen, (dr, dr), dtype),
        "b_a": torch.zeros((dr,), dtype=torch.float32, device=dev),
        "w_x": dense_init(gen, (dr, dr), dtype),
        "b_x": torch.zeros((dr,), dtype=torch.float32, device=dev),
        "w_out": dense_init(gen, (dr, d), dtype, scale=dr ** -0.5),
        "lam": lam,
    }


def _causal_conv(params, x):
    """Depthwise causal conv over the sequence, in x's dtype (``rglru.py:59-66``)."""
    w = params["conv_w"].to(x.dtype)
    cw, S = w.shape[0], x.shape[1]
    pads = torch.nn.functional.pad(x, (0, 0, cw - 1, 0))
    out = torch.zeros_like(x)
    for i in range(cw):
        out = out + pads[:, i:i + S] * w[i]
    return out + params["conv_b"].to(x.dtype)


def _gates(params, x):
    """x (..., dr) -> (a, b) in f32: h_t = a_t ⊙ h_{t-1} + b_t (``rglru.py:69-78``)."""
    xf = x.float()
    r = torch.sigmoid(xf @ params["w_a"].float() + params["b_a"])
    i = torch.sigmoid(xf @ params["w_x"].float() + params["b_x"])
    log_a = -_C * torch.nn.functional.softplus(params["lam"]) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - a.square(), min=1e-12))
    return a, beta * i * xf


def _linear_scan(a, b):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t over axis 1 from h = 0, as
    pairs under combine((a1, b1), (a2, b2)) = (a1 a2, a2 b1 + b2): the
    Hillis–Steele form, in which round k combines each position with the one
    2^k before it. -> (cumulative a, h), both the shape of a."""
    S = a.shape[1]
    d = 1
    while d < S:
        a_prev, b_prev = a[:, :-d], b[:, :-d]
        b = torch.cat([b[:, :d], a[:, d:] * b_prev + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a_prev * a[:, d:]], dim=1)
        d *= 2
    return a, b


def rglru_scan(params, x, length=None):
    """Full-sequence RG-LRU: x (B, S, dr) -> (h in x's dtype, (cumulative a, h) f32).

    ``length`` (int, optional) forces the gates to the scan's identity
    ``(a=1, b=0)`` past the valid prefix, so pad steps carry the hidden state
    through unchanged (``rglru.py:81-102``): the serving engine's
    right-padded prefill hinges on this.
    """
    a, b = _gates(params, x)
    if length is not None:
        valid = (torch.arange(x.shape[1], device=x.device) < length)[None, :, None]
        a = torch.where(valid, a, torch.ones_like(a))
        b = torch.where(valid, b, torch.zeros_like(b))
    aa, hh = _linear_scan(a, b)
    return hh.to(x.dtype), (aa, hh)


def _gate_branch(params, u):
    return gelu((u @ params["w_gate_branch"]).float()).to(u.dtype)


def rglru_block(cfg, params, u):
    """Full recurrent block. u (B, S, D) -> (B, S, D)."""
    return rglru_block_prefill(cfg, params, u)[0]


def init_rglru_state(cfg, batch: int, dtype, device) -> RGLRUState:
    dr, cw = _d_rnn(cfg), cfg.rglru.conv_width
    return RGLRUState(conv=torch.zeros((batch, cw - 1, dr), dtype=dtype, device=device),
                      h=torch.zeros((batch, dr), dtype=torch.float32, device=device))


def rglru_block_prefill(cfg, params, u, length=None):
    """Full block and its terminal ``RGLRUState`` for decode (``rglru.py:124-149``).

    With ``length`` set, pad steps are the scan's identity, so the scan's
    last h is the state after the last valid token; the conv window is the
    pre-conv input sliced at the valid length from its zero-left-extended
    copy, so a prompt shorter than conv_width-1 still gives a full window.
    """
    gate = _gate_branch(params, u)
    pre_conv = u @ params["w_rec_branch"]
    h, (_, hh) = rglru_scan(params, _causal_conv(params, pre_conv), length=length)
    y = (h * gate) @ params["w_out"]
    cw, S = cfg.rglru.conv_width, u.shape[1]
    zext = torch.nn.functional.pad(pre_conv, (0, 0, cw - 1, 0))
    start = S if length is None else int(length)
    return y, RGLRUState(conv=zext[:, start:start + cw - 1], h=hh[:, -1].float())


def rglru_block_step(cfg, params, u, state: RGLRUState):
    """One-token decode. u (B, 1, D) -> (out (B, 1, D), new state) (``rglru.py:152-162``)."""
    x = u[:, 0]
    gate = _gate_branch(params, x)
    pre = x @ params["w_rec_branch"]
    window = torch.cat([state.conv, pre[:, None, :]], dim=1)
    w = params["conv_w"].to(pre.dtype)
    rec_in = (window * w[None]).sum(dim=1) + params["conv_b"].to(pre.dtype)
    a, b = _gates(params, rec_in)
    h_new = a * state.h + b
    y = (h_new.to(x.dtype) * gate) @ params["w_out"]
    return y[:, None, :], RGLRUState(conv=window[:, 1:], h=h_new)
