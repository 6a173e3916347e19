"""Modality-frontend stub of the port (``repro.models.vision_stub``).

The vision tower and the audio codec are not implemented in either package:
requests carry precomputed patch or frame embeddings of width
``frontend_dim``.
"""
from __future__ import annotations


def num_patches(cfg) -> int:
    """Patch/frame count fed to the connector for each image/audio clip
    (``vision_stub.py:19-25``)."""
    if cfg.family == "audio":
        return cfg.enc_seq_len
    if cfg.name.startswith("minigpt4"):
        return 32  # Q-Former emits 32 query embeddings
    return 64  # ViT patch grid after merger (stand-in)
