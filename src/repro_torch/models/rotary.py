"""Rotary position embeddings (PyTorch counterpart of ``repro.models.rotary``).

Standard RoPE with the "rotate halves" convention; qwen2-vl's M-RoPE
(arXiv:2409.12191 §2.1), whose head_dim/2 frequency slots split into
``sections = (t, h, w)`` groups, each reading its own component of a
3-component position id; and no rotary at all for learned positions
(whisper) or none (the ssm family). Text tokens carry three equal
components, so on text M-RoPE equals RoPE.
"""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None):
    """(head_dim/2,) inverse frequencies in f32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    # the base made on the device (``torch.full``): a host tensor copied over
    # would make the host wait for the card at every forward
    return 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32, device=device), exps)


def rope_angles(positions, head_dim: int, theta: float):
    """positions (..., S) int -> angles (..., S, head_dim/2) f32."""
    inv = rope_freqs(head_dim, theta, positions.device)
    return positions[..., None].to(torch.float32) * inv


def mrope_angles(positions3, sections, head_dim: int, theta: float):
    """positions3 (3, B, S) int -> angles (B, S, head_dim/2) f32.

    The first ``sections[0]`` frequency slots read the temporal component,
    the next ``sections[1]`` the height, the last ``sections[2]`` the width
    (``rotary.py:26-42``).
    """
    if sum(sections) != head_dim // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not cover head_dim/2 = "
                         f"{head_dim // 2}")
    inv = rope_freqs(head_dim, theta, positions3.device)
    sel = torch.repeat_interleave(torch.arange(len(sections), device=positions3.device),
                                  torch.tensor(sections, device=positions3.device),
                                  output_size=head_dim // 2)
    pos = positions3.index_select(0, sel).permute(1, 2, 0)   # (B, S, half)
    return pos.to(torch.float32) * inv


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
    """positions (B, S) int, or (3, B, S) for M-RoPE -> (B, S, head_dim/2)
    angles, or None for ``pos_type`` "learned" (whisper adds its positions to
    the embeddings) and "none" (the ssm family has no positions). Under
    M-RoPE, (B, S) text positions broadcast to three equal components
    (``rotary.py:61-74``)."""
    hd = cfg.resolved_head_dim
    if cfg.pos_type in ("learned", "none"):
        return None
    if cfg.pos_type == "rope":
        return rope_angles(positions, hd, cfg.rope_theta)
    if cfg.pos_type == "mrope":
        if positions.ndim == 2:
            positions = positions[None].expand((3,) + tuple(positions.shape))
        return mrope_angles(positions, cfg.mrope_sections, hd, cfg.rope_theta)
    raise ValueError(f"unknown pos_type {cfg.pos_type!r}")
