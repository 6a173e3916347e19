"""Stacked NanoAdapter bank + LRU tenant cache of the port
(``repro.serving.adapter_bank``).

For each modality the per-tenant ``down``/``up`` matrices are stacked into
(N_slots, D, r) / (N_slots, r, D) tensors that the grouped LoRA kernel
indexes per row. Tenants map to bank slots through an LRU
:class:`AdapterCache`; a swap overwrites the evicted slot in place. Slot
index -1 is the implicit identity adapter (no tenant).

A loader is any callable ``tenant -> adapter dict``;
``checkpoint_adapter_loader`` reads a directory of federated checkpoints.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Optional

import torch

from repro_torch.kernels.lora import ops as lora_ops
from repro_torch.kernels.lora import ref as lora_ref
from repro_torch.models.layers import torch_dtype


class AdapterBank:
    """Per-modality stacked adapter tensors, indexed by bank slot."""

    def __init__(self, cfg, n_slots: int, device):
        if n_slots < 1:
            raise ValueError("adapter bank needs at least one slot")
        acfg = cfg.adapter
        dtype = torch_dtype(acfg.dtype)
        self.cfg = cfg
        self.n_slots = n_slots
        self.rank = acfg.rank
        self.alpha = acfg.alpha
        self.modalities = tuple(acfg.modalities)
        # zero down AND zero up: unwritten slots are exact identity adapters
        self.data = {
            mod: {
                "down": torch.zeros((n_slots, cfg.d_model, acfg.rank), dtype=dtype, device=device),
                "up": torch.zeros((n_slots, acfg.rank, cfg.d_model), dtype=dtype, device=device),
            }
            for mod in self.modalities
        }

    @property
    def scale(self) -> float:
        return self.alpha / self.rank

    def set_slot(self, slot: int, adapters: Dict) -> None:
        """Hot-swap one tenant's NanoAdapter set into ``slot``, in place
        (the JAX package rebuilds the bank with ``.at[slot].set``)."""
        if not 0 <= slot < self.n_slots:
            raise IndexError(f"slot {slot} outside bank of {self.n_slots}")
        for mod in self.modalities:
            if mod not in adapters:
                raise KeyError(f"adapter set missing modality {mod!r}")
            for name in ("down", "up"):
                ref = self.data[mod][name]
                leaf = torch.as_tensor(adapters[mod][name])
                if tuple(leaf.shape) != tuple(ref.shape[1:]):
                    raise ValueError(
                        f"{mod}/{name} shape {tuple(leaf.shape)} != bank slot shape "
                        f"{tuple(ref.shape[1:])}")
                ref[slot].copy_(leaf)

    def banks(self, mod: str):
        """(down (N, D, r), up (N, r, D)) for one modality."""
        d = self.data[mod]
        return d["down"], d["up"]


def grouped_adapter_apply(bank: AdapterBank, mod: str, x, idx, *, use_pallas: bool = False):
    """Apply per-row tenant adapters from the bank: x (..., D), idx (...) int32."""
    down, up = bank.banks(mod)
    if use_pallas:
        return lora_ops.grouped_lora_residual(x, down, up, idx, scale=bank.scale)
    return lora_ref.grouped_lora_residual(x, down, up, idx, scale=bank.scale)


class AdapterCacheMiss(KeyError):
    """A tenant's adapters are neither cached nor loadable."""


class AdapterCache:
    """LRU tenant→slot map over an :class:`AdapterBank`.

    ``acquire`` pins a tenant's slot for the lifetime of its in-flight
    requests (a pinned slot is never evicted); ``release`` unpins. Misses call
    ``loader(tenant_id)`` and install into the LRU victim.
    """

    def __init__(self, bank: AdapterBank,
                 loader: Optional[Callable[[str], Dict]] = None):
        self.bank = bank
        self.loader = loader
        self._lru: "OrderedDict[str, int]" = OrderedDict()  # tenant -> slot
        self._pins: Dict[str, int] = {}
        self._free = list(range(bank.n_slots))
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __contains__(self, tenant: Optional[str]) -> bool:
        return tenant in self._lru

    def put(self, tenant: str, adapters: Dict) -> int:
        """Install a tenant's adapters directly (no loader round trip); a
        resident tenant keeps its slot, overwritten."""
        slot = self._slot_for(tenant)
        self.bank.set_slot(slot, adapters)
        return slot

    def acquire(self, tenant: Optional[str]) -> int:
        """Pin ``tenant`` into the bank; returns its slot (-1 = identity)."""
        if tenant is None:
            return -1
        if tenant in self._lru:
            self.hits += 1
            self._lru.move_to_end(tenant)
        else:
            self.misses += 1
            if self.loader is None:
                raise AdapterCacheMiss(
                    f"tenant {tenant!r} not cached and no loader configured")
            adapters = self.loader(tenant)
            self.bank.set_slot(self._slot_for(tenant), adapters)
        self._pins[tenant] = self._pins.get(tenant, 0) + 1
        return self._lru[tenant]

    def release(self, tenant: Optional[str]) -> None:
        if tenant is None:
            return
        n = self._pins.get(tenant, 0)
        if n <= 1:
            self._pins.pop(tenant, None)
        else:
            self._pins[tenant] = n - 1

    def _slot_for(self, tenant: str) -> int:
        """Slot for a (new or resident) tenant, evicting the LRU unpinned one if needed."""
        if tenant in self._lru:
            self._lru.move_to_end(tenant)
            return self._lru[tenant]
        if self._free:
            slot = self._free.pop(0)
        else:
            victim = next((t for t in self._lru if self._pins.get(t, 0) == 0), None)
            if victim is None:
                raise AdapterCacheMiss(
                    "adapter bank thrashing: every slot is pinned by an "
                    "in-flight request — grow adapter_slots past max_slots")
            slot = self._lru.pop(victim)
            self.evictions += 1
        self._lru[tenant] = slot
        return slot

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "resident": len(self._lru)}


def checkpoint_adapter_loader(cfg, root: str) -> Callable[[str], Dict]:
    """Tenant loader over a directory of federated checkpoints: ``root/<tenant>``
    is a ``save_server_checkpoint`` directory (its ``global_adapters.npz``)
    or a bare ``<tenant>.npz`` written by ``save_pytree``; either restores
    strictly against ``init_nanoedge``'s structure for ``cfg`` (on the CPU;
    the bank copies it to its device)."""
    import os

    from repro_torch.checkpoint import load_adapters
    from repro_torch.core import adapters as nano

    reference = nano.init_nanoedge(torch.Generator().manual_seed(0), cfg)

    def load(tenant: str) -> Dict:
        path = os.path.join(root, tenant)
        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path = path + ".npz"
        return load_adapters(path, reference)

    return load
