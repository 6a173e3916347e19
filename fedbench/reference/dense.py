"""The plain reference of the dense decoder family (``vlm`` reads it too): float32
PyTorch, TF32 off, no kernel, no cache, no batching across requests,
nothing of the program. It follows the published description of a pre-norm
decoder layer (Qwen2-VL, arXiv:2409.12191 §2.1; InternLM2, arXiv:2403.17297
§2.2):

    x += Wo · attn(RoPE(Wq·rms(x) + bq), RoPE(Wk·rms(x) + bk), Wv·rms(x) + bv)
    x += Wdown · (silu(Wgate·rms(x)) ⊙ Wup·rms(x))

with grouped-query attention under a causal mask (with the configuration's
``sliding_window``, over the last that many keys only), softmax in f32,
RMSNorm with the configuration's ``rms_norm_eps``, rotate-half RoPE (M-RoPE:
the frequency slots of ``mrope_section`` read the temporal, height and width
position ids; the stub's images and the text carry equal ids, so it reduces
to RoPE), and FedNano's NanoEdge at the input: token embeddings, the image
stub's patches through a linear connector, each modality through its adapter
y = x + (alpha/r)·(x·down)·up.

Weights come in as the run's bf16 tensors and are cast to f32 one layer at a
time, so the reference fits beside them. A ``Prec`` carries the precision.

What a family's reference (``reference/<family>.py``) gives ``train.py`` and
``serve.py``: ``nanoedge``, ``layer_context`` (what every layer of one
sequence length shares), ``layer`` and ``head``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from fedbench.reference.precision import F32, Prec, f32


@dataclass
class LayerContext:
    angles: torch.Tensor      # (n, head_dim/2) rotary angles
    allowed: torch.Tensor     # (n, n) bool: query i sees key j
    eps: float                # RMSNorm's


def rmsnorm(x, scale, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * f32(scale)


def rope_angles(positions, head_dim: int, theta: float, sections=None):
    """positions (3, n) ids -> (n, head_dim/2) angles; without ``sections``
    only the first row is read (RoPE)."""
    half = head_dim // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float64, device=positions.device) / half)
    if sections is None:
        return (positions[0, :, None].double() * inv).float()
    comp = torch.repeat_interleave(torch.arange(len(sections), device=positions.device),
                                   torch.tensor(sections, device=positions.device))
    pos = positions[comp].T.double()          # (n, half): slot j reads component comp[j]
    return (pos * inv).float()


def rotate(x, angles):
    """x (rows, n, H, hd), angles (n, hd/2)."""
    half = x.shape[-1] // 2
    cos, sin = torch.cos(angles)[:, None, :], torch.sin(angles)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(s, lp, h, ctx: LayerContext, prec: Prec):
    rows, n, _ = h.shape
    hd, nh, nkv = s.head_dim, s.heads, s.kv_heads
    q = prec.mm(h, f32(lp["wq"]))
    k = prec.mm(h, f32(lp["wk"]))
    v = prec.mm(h, f32(lp["wv"]))
    if "bq" in lp:
        q, k, v = q + f32(lp["bq"]), k + f32(lp["bk"]), v + f32(lp["bv"])
    q = rotate(q.view(rows, n, nh, hd), ctx.angles)
    k = rotate(k.view(rows, n, nkv, hd), ctx.angles)
    v = v.view(rows, n, nkv, hd)
    g = nh // nkv
    qg = q.view(rows, n, nkv, g, hd).permute(0, 2, 3, 1, 4)        # (rows, kv, g, n, hd)
    kt = k.permute(0, 2, 3, 1)[:, :, None]                          # (rows, kv, 1, hd, n)
    scores = prec.mm(qg, kt) * hd ** -0.5
    p = torch.softmax(scores.masked_fill(~ctx.allowed, float("-inf")), dim=-1)
    out = prec.mm(p, v.permute(0, 2, 1, 3)[:, :, None])            # (rows, kv, g, n, hd)
    out = out.permute(0, 3, 1, 2, 4).reshape(rows, n, nh * hd)
    return prec.mm(out, f32(lp["wo"]))


def layer(s, lp, x, ctx: LayerContext, prec: Prec = F32):
    """One decoder layer on x (rows, n, D) f32."""
    x = prec.store(x + attention(s, lp["attn"], rmsnorm(x, lp["norm1"]["scale"], ctx.eps),
                                 ctx, prec))
    h = prec.store(rmsnorm(x, lp["norm2"]["scale"], ctx.eps))
    m = lp["mlp"]
    y = prec.store(F.silu(prec.mm(h, f32(m["w_gate"]))) * prec.mm(h, f32(m["w_up"])))
    return prec.store(x + prec.mm(y, f32(m["w_down"])))


def adapt(x, adapter, scale: float, prec: Prec = F32):
    """NanoAdapter: x + scale·(x·down)·up, in f32."""
    return prec.store(x + prec.mm(prec.mm(x, adapter["down"]), adapter["up"]) * scale)


def nanoedge(s, w, adapters, tokens, patches, scale: float, prec: Prec = F32):
    """Embeddings of one client's rows: the image prefix (connector, then the
    image adapter) before the adapted token embeddings. -> (rows, n, D) f32."""
    x = f32(w["embed"]["table"][tokens])
    if adapters is not None and "text" in adapters:
        x = adapt(x, adapters["text"], scale, prec)
    if patches is not None:
        c = w["connector"]
        img = prec.mm(f32(patches), f32(c["w"])) + f32(c["b"])
        if adapters is not None and "image" in adapters:
            img = adapt(img, adapters["image"], scale, prec)
        x = torch.cat([img, x], dim=1)
    return prec.store(x)


def head(w, h, ctx: LayerContext, prec: Prec = F32):
    """Final norm and logits of hidden rows h (..., D) f32 (from the
    embedding table where the configuration ties the two)."""
    table = (w["unembed"] if "unembed" in w else w["embed"])["table"]
    return prec.mm(rmsnorm(h, w["final_norm"]["scale"], ctx.eps), f32(table).T)


def layer_context(s, cfg: dict, n: int, device) -> LayerContext:
    """What every layer shares over sequences of ``n`` positions."""
    rs = cfg.get("rope_scaling") or {}
    sections = rs.get("mrope_section")
    pos = torch.arange(n, device=device)
    allowed = pos[None, :] <= pos[:, None]
    if s.window:
        allowed &= pos[:, None] - pos[None, :] < s.window
    angles = rope_angles(pos[None].expand(3, n), s.head_dim, float(cfg["rope_theta"]), sections)
    return LayerContext(angles=angles, allowed=allowed, eps=float(cfg["rms_norm_eps"]))
