"""Modality-frontend stub of the port (``repro.models.vision_stub``).

The vision tower and the audio codec are not implemented in either package:
requests carry precomputed patch or frame embeddings of width
``frontend_dim``. ``patch_embeddings`` and ``topic_patch_embeddings`` draw
such pseudo-embeddings from a ``torch.Generator``, on its device; the JAX
package's ``jax.random`` draws cannot be reproduced, so the two packages
agree on shapes, dtypes and the topic identity, not on values.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import normal


def num_patches(cfg) -> int:
    """Patch/frame count fed to the connector for each image/audio clip
    (``vision_stub.py:19-25``)."""
    if cfg.family == "audio":
        return cfg.enc_seq_len
    if cfg.name.startswith("minigpt4"):
        return 32  # Q-Former emits 32 query embeddings
    return 64  # ViT patch grid after merger (stand-in)


def patch_embeddings(gen, cfg, batch: int, dtype=torch.float32):
    """Deterministic pseudo patch/frame embeddings (B, M, frontend_dim)."""
    return normal(gen, (batch, num_patches(cfg), cfg.frontend_dim)).to(dtype)


def topic_patch_embeddings(gen, cfg, topic_vecs, dtype=torch.float32):
    """Patch embeddings whose mean is steered by a per-example topic vector:
    topic_vecs (B, frontend_dim) plus 0.5 · N(0, 1) noise per patch."""
    noise = normal(gen, (topic_vecs.shape[0], num_patches(cfg), cfg.frontend_dim)) * 0.5
    return (topic_vecs[:, None, :] + noise).to(dtype)
