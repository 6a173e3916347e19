"""Multi-tenant serving of the port (``repro.serving``)."""
from repro_torch.serving.adapter_bank import (
    AdapterBank,
    AdapterCache,
    AdapterCacheMiss,
    checkpoint_adapter_loader,
    grouped_adapter_apply,
)
from repro_torch.serving.engine import Completion, Request, ServingEngine, generate_naive
from repro_torch.serving.kv_cache import KVSlotManager

__all__ = ["AdapterBank", "AdapterCache", "AdapterCacheMiss", "Completion",
           "KVSlotManager", "Request", "ServingEngine", "checkpoint_adapter_loader",
           "generate_naive", "grouped_adapter_apply"]
