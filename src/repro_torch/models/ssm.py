"""Mamba2 block of the port (PyTorch counterpart of ``repro.models.ssm``).

    u -> in_proj -> [z | xBC | dt]
         xBC -> causal depthwise conv1d -> silu -> [x | B | C]
         x (B, S, H, P), dt (B, S, H) -> softplus(dt + dt_bias)
         y = SSD(x, dt, A, B, C) + D ⊙ x
         y -> gated RMSNorm(y, z) -> out_proj

Training and prefill run the chunked SSD scan: the hand-written kernel under
``cfg.use_pallas`` (``kernels.ssd_scan.ops.ssd``), else its plain version.
The JAX package reaches its kernel only in ``ssm_apply``; its prefill always
runs the plain version, which computes the same function, so here prefill
takes the kernel too. The terminal state (``_final_state``) and the decode
step are plain torch, as in the JAX package. The dtype order is the JAX
package's: the conv accumulates in the activation dtype, ``dt`` is a
softplus in f32 cast to the activation dtype for the scan, the D skip runs
in the activation dtype.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.models.layers import dense_init, normal, uniform


class SSMState(NamedTuple):
    conv: torch.Tensor  # (B, d_conv-1, conv_dim): trailing conv window, model dtype
    h: torch.Tensor     # (B, H, P, N) f32: SSM state


def _dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.d_state
    return d_inner, n_heads, conv_dim


def init_ssm(gen, cfg, dtype):
    """Random block params from a seeded generator (``ssm.py::init_ssm``)."""
    s = cfg.ssm
    d = cfg.d_model
    d_inner, H, conv_dim = _dims(cfg)
    dev = gen.device
    u = uniform(gen, (H,))
    dt = torch.exp(u * (math.log(s.dt_max) - math.log(s.dt_min)) + math.log(s.dt_min))
    dt_bias = dt + torch.log(-torch.expm1(-dt))  # inverse softplus
    conv_w = normal(gen, (s.d_conv, conv_dim))
    return {
        "in_proj": dense_init(gen, (d, 2 * d_inner + 2 * s.d_state + H), dtype),
        "conv_w": (conv_w * 0.1).to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.arange(1, H + 1, dtype=torch.float32, device=dev)),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "dt_bias": dt_bias,
        "norm_scale": torch.ones((d_inner,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, (d_inner, d), dtype, scale=d_inner ** -0.5),
    }


def _gated_rmsnorm(scale, y, z, eps=1e-6):
    """Gate in y's dtype, normalize in f32."""
    y = y * F.silu(z.float()).to(y.dtype)
    yf = y.float()
    var = yf.square().mean(dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)


def _split_proj(cfg, zxbcdt):
    s = cfg.ssm
    d_inner, _, _ = _dims(cfg)
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:2 * d_inner + 2 * s.d_state]
    dt = zxbcdt[..., 2 * d_inner + 2 * s.d_state:]
    return z, xBC, dt


def _causal_conv(params, xBC):
    """Depthwise causal conv over time, accumulated in xBC's dtype from zeros."""
    w = params["conv_w"].to(xBC.dtype)  # (d_conv, conv_dim)
    d_conv, S = w.shape[0], xBC.shape[1]
    pads = F.pad(xBC, (0, 0, d_conv - 1, 0))
    out = torch.zeros_like(xBC)
    for i in range(d_conv):
        out = out + pads[:, i:i + S] * w[i]
    return out + params["conv_b"].to(xBC.dtype)


def _split_xbc(cfg, xBC):
    """-> x (B, S, H, P), B (B, S, N), C (B, S, N): views of xBC."""
    s = cfg.ssm
    d_inner, H, _ = _dims(cfg)
    x = xBC[..., :d_inner].reshape(*xBC.shape[:-1], H, s.head_dim)
    return x, xBC[..., d_inner:d_inner + s.d_state], xBC[..., d_inner + s.d_state:]


def _scan(cfg, use_pallas, x, dt, A, Bm, Cm):
    # the wrapper is looked up at every call, so a caller may swap it
    fn = ssd_ops.ssd if use_pallas else ssd_ref.ssd_chunked
    return fn(x, dt, A, Bm, Cm, chunk=cfg.ssm.chunk_size)


def _out(cfg, params, x, y, z):
    d_inner, _, _ = _dims(cfg)
    y = y + x * params["D"][:, None].to(x.dtype)
    y = _gated_rmsnorm(params["norm_scale"], y.reshape(*y.shape[:-2], d_inner), z)
    return y @ params["out_proj"]


def ssm_apply(cfg, params, u, *, use_pallas: bool = False):
    """Full-sequence Mamba2 block. u (B, S, D) -> (B, S, D)."""
    z, xBC, dt = _split_proj(cfg, u @ params["in_proj"])
    x, Bm, Cm = _split_xbc(cfg, F.silu(_causal_conv(params, xBC)))
    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    y = _scan(cfg, use_pallas, x, dt.to(x.dtype), A, Bm, Cm)
    return _out(cfg, params, x, y, z)


def init_ssm_state(cfg, batch: int, dtype, device) -> SSMState:
    s = cfg.ssm
    _, H, conv_dim = _dims(cfg)
    return SSMState(
        conv=torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=dtype, device=device),
        h=torch.zeros((batch, H, s.head_dim, s.d_state), dtype=torch.float32, device=device))


def ssm_prefill(cfg, params, u, length=None, *, use_pallas: bool = False):
    """Full sequence AND the terminal SSMState for decoding.

    ``length`` (int, optional) marks only the first ``length`` positions as
    real: ``dt`` is zeroed on the tail, so pad steps decay by exp(0) = 1 and
    add 0, and the terminal state equals the unpadded run's. The conv window
    is sliced at ``length`` from the input left-extended with zeros (the
    causal conv's convention), so a prompt shorter than d_conv - 1 keeps its
    zeros (``ssm.py:126-161``).
    """
    s = cfg.ssm
    Bsz, S, _ = u.shape
    _, _, conv_dim = _dims(cfg)
    z, xBC, dt = _split_proj(cfg, u @ params["in_proj"])
    zext = torch.cat([xBC.new_zeros((Bsz, s.d_conv - 1, conv_dim)), xBC], dim=1)
    end = S + s.d_conv - 1 if length is None else int(length) + s.d_conv - 1
    conv_tail = zext[:, end - (s.d_conv - 1):end]
    x, Bm, Cm = _split_xbc(cfg, F.silu(_causal_conv(params, xBC)))
    dtp = F.softplus(dt.float() + params["dt_bias"])
    if length is not None:
        valid = torch.arange(S, device=u.device) < int(length)
        dtp = torch.where(valid[None, :, None], dtp, torch.zeros_like(dtp))
    A = -torch.exp(params["A_log"])
    y = _scan(cfg, use_pallas, x, dtp.to(x.dtype), A, Bm, Cm)
    out = _out(cfg, params, x, y, z)
    h_final = _final_state(x, dtp, A, Bm, s.chunk_size)
    return out, SSMState(conv=conv_tail, h=h_final)


def _final_state(x, dt, A, Bm, chunk: int):
    """Exact terminal SSM state h_S (B, H, P, N) by the chunked recurrence.

    dt comes in f32 (not cast to x's dtype), as in ``ssm.py::_final_state``.
    """
    *_, h = ssd_ref.chunk_states(x, dt, A, Bm, chunk)
    return h.transpose(-1, -2)


def ssm_decode_step(cfg, params, u, state: SSMState):
    """One-token decode. u (B, 1, D) -> (out (B, 1, D), new SSMState)."""
    s = cfg.ssm
    Bsz = u.shape[0]
    d_inner, H, _ = _dims(cfg)
    z, xBC, dt = _split_proj(cfg, u[:, 0] @ params["in_proj"])
    window = torch.cat([state.conv, xBC[:, None, :]], dim=1)     # (B, d_conv, conv_dim)
    w = params["conv_w"].to(xBC.dtype)
    conv_out = torch.sum(window * w[None], dim=1) + params["conv_b"].to(xBC.dtype)
    xBCc = F.silu(conv_out)
    x = xBCc[..., :d_inner].reshape(Bsz, H, s.head_dim)
    Bm = xBCc[..., d_inner:d_inner + s.d_state]
    Cm = xBCc[..., d_inner + s.d_state:]
    dtp = F.softplus(dt.float() + params["dt_bias"])             # (B, H)
    A = -torch.exp(params["A_log"])
    y, h_new = ssd_ref.ssd_decode_step(state.h, x, dtp, A, Bm, Cm)
    out = _out(cfg, params, x, y, z)[:, None, :]
    return out, SSMState(conv=window[:, 1:], h=h_new)
