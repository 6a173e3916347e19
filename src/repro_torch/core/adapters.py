"""NanoEdge & NanoAdapters of the port (``repro.core.adapters``).

A NanoAdapter is a low-rank residual map at the connector→LLM interface,

    y = x + (alpha / rank) · (x · W_down) · W_up,

with ``W_up`` zero-initialized, one per modality: text token embeddings and
connected image (or, for the audio family, frame) embeddings.
``nanoedge_forward`` is the client half of the split execution: embed +
connect + adapt. With ``clients=K`` it runs a cohort: K clients' stacked
adapters on their own batches' rows, folded into one batch of K·B rows for
the backbone (the vmap engine's pass).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.core.types import Batch
from repro_torch.kernels.lora import ops as lora_ops
from repro_torch.models import model as model_lib
from repro_torch.models.layers import dense_init, torch_dtype


def init_nano_adapter(gen, d_model: int, rank: int, dtype=torch.float32):
    """LoRA-style pair; up-projection zero-init => identity at init."""
    return {
        "down": dense_init(gen, (d_model, rank), dtype),
        "up": torch.zeros((rank, d_model), dtype=dtype, device=gen.device),
    }


def init_nanoedge(gen, cfg) -> Dict:
    """Trainable NanoAdapter params, one entry per configured modality."""
    acfg = cfg.adapter
    dtype = torch_dtype(acfg.dtype)
    return {mod: init_nano_adapter(gen, cfg.d_model, acfg.rank, dtype)
            for mod in acfg.modalities}


def adapter_param_count(cfg) -> int:
    """Trainable NanoEdge parameters: one (D, r) and one (r, D) per modality."""
    return len(cfg.adapter.modalities) * 2 * cfg.d_model * cfg.adapter.rank


def nano_adapter_apply(params, x, *, rank: int, alpha: float, use_pallas: bool = False):
    """y = x + (alpha/rank) · (x·down)·up.

    Two paths, as in the JAX package, which differ in bf16:
      * kernel path (``use_pallas``): the LoRA kernel, f32 math inside and
        one cast to x's dtype at the end (``lora.py:30-35``);
      * plain path: the products run in the activation dtype, the f32
        adapters cast at use (``adapters.py:58-60``).
    """
    scale = alpha / rank
    if use_pallas:
        return lora_ops.lora_residual(x, params["down"], params["up"], scale=scale)
    h = x @ params["down"].to(x.dtype)
    return x + (h @ params["up"].to(x.dtype)) * scale


def nano_adapter_apply_many(params, x, *, rank: int, alpha: float, use_pallas: bool = False):
    """:func:`nano_adapter_apply` of K clients: x (K, T, D), each row block
    through its own adapter, params' leaves (K, D, r) and (K, r, D). The
    kernel path is one ``lora_residual_many`` call; the plain path batched
    products in the activation dtype, as one client's."""
    scale = alpha / rank
    if use_pallas:
        return lora_ops.lora_residual_many(x, params["down"], params["up"], scale=scale)
    h = torch.bmm(x, params["down"].to(x.dtype))
    return x + torch.bmm(h, params["up"].to(x.dtype)) * scale


def adapt(params, x, *, rank: int, alpha: float, use_pallas: bool,
          clients: Optional[int] = None):
    """One client's adapter on x (..., L, D), or with ``clients`` K stacked
    adapters on x (K, ..., L, D), client k's rows through adapter k."""
    kw = dict(rank=rank, alpha=alpha, use_pallas=use_pallas)
    if clients is None:
        return nano_adapter_apply(params, x, **kw)
    y = nano_adapter_apply_many(params, x.reshape(clients, -1, x.shape[-1]), **kw)
    return y.reshape(x.shape)


def nanoedge_forward(cfg, backbone, adapters, batch: Batch, *, clients: Optional[int] = None):
    """Client-side compute: embed + connect + adapt (``adapters.py:79-125``).

    Returns (embeds, positions, labels, mask, enc_embeds): for an image
    family embeds (B, M+S, D) with the image prefix unsupervised; for the
    audio family the decoder's token embeddings (B, S, D) and, last, the
    adapted frame embeddings (B, M, D) of the encoder stream, which take no
    decoder position; None there for the other families.

    ``clients=K``: the adapters' leaves are K clients' stacked (K, ...) and
    the batch's (K, B, ...) (a batch all K share may come as an ``expand``ed
    view); client k's rows meet only its adapters, and the outputs fold the
    clients into the batch axis, K·B rows, client-major.
    """
    model_lib.check_supported(cfg)
    acfg = cfg.adapter
    kw = dict(rank=acfg.rank, alpha=acfg.alpha, use_pallas=cfg.use_pallas, clients=clients)
    fold = (lambda t: t) if clients is None else (lambda t: t.reshape(-1, *t.shape[2:]))

    tok_emb = model_lib.embed_tokens(cfg, backbone, batch.tokens)
    if "text" in adapters:
        tok_emb = adapt(adapters["text"], tok_emb, **kw)
    lead, S = batch.tokens.shape[:-1], batch.tokens.shape[-1]
    rows = math.prod(lead)
    dev = tok_emb.device

    if cfg.family == "audio":
        enc = model_lib.connect(cfg, backbone, batch.patches)
        if "image" in adapters:
            enc = adapt(adapters["image"], enc, **kw)
        positions = torch.arange(S, dtype=torch.long, device=dev).expand(rows, S)
        return fold(tok_emb), positions, fold(batch.labels), fold(batch.mask), fold(enc)

    if cfg.frontend_dim and batch.patches is not None:
        img = model_lib.connect(cfg, backbone, batch.patches)
        if "image" in adapters:
            img = adapt(adapters["image"], img, **kw)
        M = img.shape[-2]
        embeds = torch.cat([img.to(tok_emb.dtype), tok_emb], dim=-2)
        positions = torch.arange(M + S, dtype=torch.long, device=dev).expand(rows, M + S)
        labels = torch.cat([batch.labels.new_zeros((*lead, M)), batch.labels], dim=-1)
        mask = torch.cat([batch.mask.new_zeros((*lead, M)), batch.mask], dim=-1)
        return fold(embeds), positions, fold(labels), fold(mask), None

    positions = torch.arange(S, dtype=torch.long, device=dev).expand(rows, S)
    return fold(tok_emb), positions, fold(batch.labels), fold(batch.mask), None


def fednano_loss(cfg, backbone, adapters, batch: Batch):
    """End-to-end FedNano loss: client NanoEdge -> frozen server backbone.

    Differentiate with respect to ``adapters`` only: the backbone's tensors
    never require grad, so autograd reaches them as constants.
    Returns (loss, aux).
    """
    embeds, positions, labels, mask, enc = nanoedge_forward(cfg, backbone, adapters, batch)
    return model_lib.loss_fn(cfg, backbone, embeds, positions, labels, mask, enc)
