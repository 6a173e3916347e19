"""Rotary position embeddings (PyTorch counterpart of ``repro.models.rotary``).

Standard RoPE with the "rotate halves" convention. M-RoPE (qwen2-vl) joins
with that family (ROADMAP queue 3).
"""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None):
    """(head_dim/2,) inverse frequencies in f32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exps)


def rope_angles(positions, head_dim: int, theta: float):
    """positions (..., S) int -> angles (..., S, head_dim/2) f32."""
    inv = rope_freqs(head_dim, theta, positions.device)
    return positions[..., None].to(torch.float32) * inv


def apply_rotary(x, angles):
    """x (..., S, H, D), angles (..., S, D/2) -> rotated x (same dtype).

    cos/sin are computed in f32 and cast to the activation dtype before the
    rotation, which then runs in that dtype (``rotary.py:54-58``).
    """
    half = x.shape[-1] // 2
    cos = torch.cos(angles)[..., None, :].to(x.dtype)  # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :].to(x.dtype)
    x1 = x[..., :half]
    x2 = x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def make_angles(cfg, positions):
    """positions (B, S) int -> (B, S, head_dim/2) angles."""
    if cfg.pos_type != "rope":
        raise NotImplementedError(f"pos_type={cfg.pos_type!r}: the port runs rope only "
                                  "(M-RoPE and learned positions: ROADMAP queue 3)")
    return rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta)
