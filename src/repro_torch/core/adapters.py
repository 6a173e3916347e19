"""NanoEdge & NanoAdapters of the port (``repro.core.adapters``).

A NanoAdapter is a low-rank residual map at the connector→LLM interface,

    y = x + (alpha / rank) · (x · W_down) · W_up,

with ``W_up`` zero-initialized, one per modality: text token embeddings and
connected image embeddings. ``nanoedge_forward`` is the client half of the
split execution: embed + connect + adapt.
"""
from __future__ import annotations

from typing import Dict

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


def nanoedge_forward(cfg, backbone, adapters, batch: Batch):
    """Client-side compute: embed + connect + adapt.

    Returns (embeds (B, M+S, D), positions (B, M+S), labels, mask, None);
    the image prefix is unsupervised. The last slot is the audio encoder
    stream of the JAX package, which arrives with that family.
    """
    model_lib.check_supported(cfg)
    acfg = cfg.adapter
    kw = dict(rank=acfg.rank, alpha=acfg.alpha, use_pallas=cfg.use_pallas)

    tok_emb = model_lib.embed_tokens(cfg, backbone, batch.tokens)
    if "text" in adapters:
        tok_emb = nano_adapter_apply(adapters["text"], tok_emb, **kw)
    B, S = batch.tokens.shape
    dev = tok_emb.device

    if cfg.frontend_dim and batch.patches is not None:
        img = model_lib.connect(cfg, backbone, batch.patches)
        if "image" in adapters:
            img = nano_adapter_apply(adapters["image"], img, **kw)
        M = img.shape[1]
        embeds = torch.cat([img.to(tok_emb.dtype), tok_emb], dim=1)
        positions = torch.arange(M + S, dtype=torch.long, device=dev).expand(B, M + S)
        labels = torch.cat([batch.labels.new_zeros((B, M)), batch.labels], dim=1)
        mask = torch.cat([batch.mask.new_zeros((B, M)), batch.mask], dim=1)
        return embeds, positions, labels, mask, None

    positions = torch.arange(S, dtype=torch.long, device=dev).expand(B, S)
    return tok_emb, positions, batch.labels, batch.mask, None


def fednano_loss(cfg, backbone, adapters, batch: Batch):
    """End-to-end FedNano loss: client NanoEdge -> frozen server backbone.

    Differentiate with respect to ``adapters`` only: the backbone's tensors
    never require grad, so autograd reaches them as constants.
    Returns (loss, aux).
    """
    embeds, positions, labels, mask, _ = nanoedge_forward(cfg, backbone, adapters, batch)
    return model_lib.loss_fn(cfg, backbone, embeds, positions, labels, mask)
