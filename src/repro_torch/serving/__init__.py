"""Multi-tenant serving of the port (``repro.serving``)."""
from repro_torch.serving.adapter_bank import (
    AdapterBank,
    AdapterCache,
    AdapterCacheMiss,
    grouped_adapter_apply,
)
from repro_torch.serving.engine import Completion, Request, ServingEngine
from repro_torch.serving.kv_cache import KVSlotManager

__all__ = ["AdapterBank", "AdapterCache", "AdapterCacheMiss", "Completion",
           "KVSlotManager", "Request", "ServingEngine", "grouped_adapter_apply"]
