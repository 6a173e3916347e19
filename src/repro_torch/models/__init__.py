"""Backbone layers, attention and the decoder stack of the port."""
from repro_torch.models import (attention, encdec, layers, model, moe, rglru, rotary, ssm,
                                transformer, vision_stub)

__all__ = ["attention", "encdec", "layers", "model", "moe", "rglru", "rotary", "ssm",
           "transformer", "vision_stub"]
