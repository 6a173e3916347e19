"""Slot-paged decode-state pool of the port (``repro.serving.kv_cache``).

The engine owns ONE fixed-shape decode state for ``n_slots`` concurrent
requests: the stacked KV cache (L, n_slots, C, n_kv, hd), where a
sliding-window config's C is a ring of at most the window; for the ssm
family the stacked recurrent state (conv windows in the model dtype, h in
f32); for the hybrid family both, by triple and extra layer; for the
encoder-decoder family the self KV and the cross KV. Every leaf has the
page on axis 1. A request occupies one page (slot) from admission to completion;
prefill's single-request state is copied into its page, and finishing frees
the page. Per-slot positions are tracked on the host: slot j of a page is
valid iff j <= pos, so a freed page needs no scrubbing.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.models import model as model_lib
from repro_torch.utils import tree_bytes, tree_leaves


class KVSlotManager:
    """Fixed pool of decode pages over the model's stacked decode state."""

    def __init__(self, cfg, n_slots: int, capacity: int, dtype, device):
        self.cfg = cfg
        self.n_slots = n_slots
        self.capacity = capacity
        self.state = model_lib.init_state(cfg, n_slots, capacity, dtype, device)
        self._free: List[int] = list(range(n_slots))
        self.pos = np.zeros((n_slots,), np.int64)  # next decode position

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self) -> Optional[int]:
        """Claim a free page; None when the pool is saturated."""
        if not self._free:
            return None
        return self._free.pop(0)

    def free(self, slot: int) -> None:
        if slot in self._free:
            raise ValueError(f"double free of slot {slot}")
        self._free.append(slot)
        self._free.sort()  # deterministic reuse order
        self.pos[slot] = 0

    def write(self, slot: int, page, start_pos: int) -> None:
        """Install a single-request prefill state into ``slot``, in place,
        every leaf of the state tree on its batch axis 1, each in the pool's
        own dtype (``kv_cache.py:29-34``; the JAX package's
        ``dynamic_update_index_in_dim`` returns a new pool)."""
        for pool_t, page_t in zip(tree_leaves(self.state), tree_leaves(page), strict=True):
            pool_t[:, slot].copy_(page_t[:, 0])
        self.pos[slot] = start_pos


    def page_bytes(self) -> int:
        """Bytes of one page: what admitting a request costs."""
        return tree_bytes(self.state) // self.n_slots

    def pool_bytes(self) -> int:
        return tree_bytes(self.state)
