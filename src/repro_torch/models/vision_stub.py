"""Modality-frontend stub of the port (``repro.models.vision_stub``).

The vision tower is not implemented in either package: requests carry
precomputed patch embeddings of width ``frontend_dim``.
"""
from __future__ import annotations


def num_patches(cfg) -> int:
    """Patch count fed to the connector for each image (the audio family's
    frame count arrives with that family)."""
    if cfg.name.startswith("minigpt4"):
        return 32  # Q-Former emits 32 query embeddings
    return 64  # ViT patch grid after merger (stand-in)
