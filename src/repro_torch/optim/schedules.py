"""Learning-rate schedules, plain callables step -> lr (``repro.optim.schedules``).

Each returns an f32 0-d tensor, for an int step or a tensor step (on that
step's device). An int step is divided in Python before the f32 arithmetic,
a tensor step in f32, as ``jnp`` divides a Python int and an int32 array.
"""
from __future__ import annotations

import math

import torch

F32 = torch.float32


def _ratio(step, n: int):
    """step / n as an f32 0-d tensor."""
    if isinstance(step, torch.Tensor):
        return step.to(F32) / n
    return torch.tensor(step / n, dtype=F32)


def constant_schedule(lr: float):
    return lambda step: torch.tensor(lr, dtype=F32,
                                     device=step.device if isinstance(step, torch.Tensor) else None)


def cosine_schedule(lr: float, total_steps: int, final_frac: float = 0.1):
    def f(step):
        t = torch.clamp(_ratio(step, max(total_steps, 1)), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return (lr * (final_frac + (1 - final_frac) * cos)).to(F32)

    return f


def linear_warmup_cosine(lr: float, warmup: int, total_steps: int, final_frac: float = 0.1):
    cos = cosine_schedule(lr, max(total_steps - warmup, 1), final_frac)

    def f(step):
        warm = lr * torch.clamp(_ratio(step, max(warmup, 1)), max=1.0)
        after = cos(step - warmup)
        return torch.where(torch.as_tensor(step < warmup, device=after.device), warm,
                           after).to(F32)

    return f
