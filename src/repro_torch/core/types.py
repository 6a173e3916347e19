"""Shared datatypes of the port's FedNano core (``repro.core.types``)."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class Batch(NamedTuple):
    """One multimodal VQA batch (image-question-answer triplets).

    tokens  (B, S) int     — question+answer token ids (client tokenizer)
    labels  (B, S) int     — next-token targets (shifted)
    mask    (B, S) f32     — 1.0 on supervised (answer) positions
    patches (B, M, F) f32  — stubbed frontend patch embeddings, or None
    """

    tokens: torch.Tensor
    labels: torch.Tensor
    mask: torch.Tensor
    patches: Optional[torch.Tensor] = None
