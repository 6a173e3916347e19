"""Multi-tenant continuous-batching serving engine of the port
(``repro.serving.engine``).

One frozen backbone, many tenants' NanoAdapters. Every engine step first
admits queued requests into free pages of the decode-state pool (one
prefill each), then runs ONE decode step over all pages: embed -> grouped
per-tenant text adapter -> decode with one position per page.

Exactness: prompts are right-padded to ``prefill_len``. Under the causal
mask pad rows never influence real rows, and pad KV at slots
``[L_real, prefill_len)`` is only attended after decode has overwritten it
(decode at position p writes slot p before attending slots <= p), so padded
prefill + batched decode gives the tokens of one request at a time. For a
config with a ring (a sliding window, or the hybrid family's local
attention window) the same argument needs the padded prefill to fit the
smallest ring, which ``__init__`` checks (``engine.py:71-110``); decode then
wraps the ring past the window. The recurrent families (ssm, and the hybrid
family's RG-LRU layers) integrate every prefill step into their state, so
the engine passes the true length down to ``model.prefill``: pad steps are
an exact identity on the state (dt = 0 for the SSD scan, (a, b) = (1, 0)
for RG-LRU) and the conv windows are sliced at that length. The audio
family's frames run through the encoder and the cross-attention and take no
decoder position; each page holds its own cross KV. In the MoE family the
pads route with the prompt and take expert capacity in prefill, as in the
JAX engine, and a decode step routes each page alone (``moe_group=1``), as
the JAX engine's ``vmap`` over pages does (``engine.py:175-187``): a page's
tokens never depend on the other pages.

``generate_naive`` is the one-request-at-a-time baseline the engine must
match token for token.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import adapters as nano
from repro_torch.core.types import Batch
from repro_torch.models import model as model_lib
from repro_torch.models.vision_stub import num_patches
from repro_torch.serving.adapter_bank import AdapterBank, AdapterCache, grouped_adapter_apply
from repro_torch.serving.kv_cache import KVSlotManager


@dataclass
class Request:
    """One generation request: a tenant id (None = base model, no adapter),
    an unpadded prompt, optionally image patches or audio frames, and a
    token budget."""

    rid: int
    tenant: Optional[str]
    prompt: np.ndarray                    # (L,) int32, L <= prefill_len
    patches: Optional[np.ndarray] = None  # (M, frontend_dim) f32
    max_new_tokens: int = 8


@dataclass
class Completion:
    rid: int
    tenant: Optional[str]
    tokens: List[int] = field(default_factory=list)


def _min_window(cfg) -> Optional[int]:
    """The smallest attention ring of the config: its sliding window, or the
    hybrid family's local window (``engine.py:71-77``); None without one."""
    ws = []
    if cfg.sliding_window is not None:
        ws.append(cfg.sliding_window)
    if cfg.family == "hybrid" and cfg.rglru is not None:
        ws.append(cfg.rglru.local_window)
    return min(ws) if ws else None


class ServingEngine:
    def __init__(self, cfg, backbone, *, max_slots: int = 8,
                 prefill_len: int = 32, max_new_tokens: int = 32, adapter_slots: int = 8,
                 adapter_loader=None, stop_token: Optional[int] = None,
                 use_pallas_grouped: bool = False):
        model_lib.check_supported(cfg)
        self.cfg = cfg
        self.backbone = backbone
        self.device = backbone["embed"]["table"].device
        self.max_slots = max_slots
        self.prefill_len = prefill_len
        self.stop_token = stop_token
        self.use_pallas_grouped = use_pallas_grouped

        # image tokens prepend to the decoder stream; the audio encoder stream
        # runs through cross-attention and takes no decoder slot
        self.img_prefix = num_patches(cfg) if cfg.frontend_dim and cfg.family != "audio" else 0
        self.capacity = self.img_prefix + prefill_len + max_new_tokens + 1
        w = _min_window(cfg)
        if w is not None and self.img_prefix + prefill_len > w:
            raise ValueError(
                f"padded prefill ({self.img_prefix + prefill_len}) exceeds the attention "
                f"window ({w}): pad slots would evict live KV from the ring; lower "
                "prefill_len or serve a longer-window config")

        self.bank = AdapterBank(cfg, adapter_slots, self.device)
        self.cache = AdapterCache(self.bank, loader=adapter_loader)
        self.slots = KVSlotManager(cfg, max_slots, self.capacity,
                                   model_lib.param_dtype(cfg), self.device)

        self._aslot = np.full((max_slots,), -1, np.int32)   # bank slot per page
        self._last_tok = np.zeros((max_slots,), np.int64)
        self._active: Dict[int, Completion] = {}
        self._budget: Dict[int, int] = {}
        self._queue: "deque[Request]" = deque()
        # host-clock seconds of prefill and decode, each ending in the host
        # reading the chosen tokens (which waits for the device)
        self.stats = {"decode_steps": 0, "prefills": 0, "occupancy_sum": 0,
                      "prefill_s": 0.0, "decode_s": 0.0}

    # -- queue interface ----------------------------------------------------

    def submit(self, request: Request) -> None:
        if len(request.prompt) > self.prefill_len:
            raise ValueError(
                f"prompt of {len(request.prompt)} exceeds prefill_len={self.prefill_len}")
        self._queue.append(request)

    def run(self, requests: Optional[List[Request]] = None) -> Dict[int, Completion]:
        """Drain the queue; returns {rid: Completion} in completion order."""
        for r in requests or []:
            self.submit(r)
        done: Dict[int, Completion] = {}
        while self._queue or self._active:
            self._admit(done)
            self._step(done)
        return done

    def prefill_logits(self, request: Request) -> torch.Tensor:
        """f32 logits (V,) of the prefill at the prompt's last token, for
        checking one request against another configuration of the engine."""
        aslot = self.cache.acquire(request.tenant)
        try:
            _, lg, _ = self._prefill(request, aslot)
        finally:
            self.cache.release(request.tenant)
        return lg.float()

    # -- internals ----------------------------------------------------------

    def _gather_adapters(self, aslot: int):
        """Per-request adapter set from the bank (-1 => exact identity:
        ``up`` zeroed, ``engine.py:126-133``)."""
        live = 1.0 if aslot >= 0 else 0.0
        safe = max(aslot, 0)
        return {mod: {"down": d["down"][safe], "up": d["up"][safe] * live}
                for mod, d in self.bank.data.items()}

    def _prefill(self, r: Request, aslot: int):
        """-> (single-request decode state, logits (V,) at last_idx, last_idx)."""
        prompt = np.asarray(r.prompt, np.int64)
        L = len(prompt)
        tokens = np.zeros((1, self.prefill_len), np.int64)
        tokens[0, :L] = prompt
        tokens = torch.from_numpy(tokens).to(self.device)
        patches = None
        if r.patches is not None:
            patches = torch.as_tensor(np.asarray(r.patches, np.float32)[None], device=self.device)
        batch = Batch(tokens=tokens, labels=torch.zeros_like(tokens),
                      mask=torch.zeros(tokens.shape, dtype=torch.float32, device=self.device),
                      patches=patches)
        embeds, positions, _, _, enc = nano.nanoedge_forward(
            self.cfg, self.backbone, self._gather_adapters(aslot), batch)
        last_idx = self.img_prefix + L - 1
        state, hidden = model_lib.prefill(self.cfg, self.backbone, embeds, positions,
                                          self.capacity, enc_embeds=enc, length=last_idx + 1)
        # logits at last_idx only (engine.py:149-151)
        lg = model_lib.logits(self.cfg, self.backbone, hidden[:, last_idx:last_idx + 1])
        return state, lg[0, 0], last_idx

    def _admit(self, done: Dict[int, Completion]) -> None:
        while self._queue and self.slots.n_free > 0:
            r = self._queue.popleft()
            aslot = self.cache.acquire(r.tenant)
            t0 = time.perf_counter()
            page, lg, last_idx = self._prefill(r, aslot)
            tok0 = int(torch.argmax(lg))  # first index on ties, as jnp.argmax
            self.stats["prefill_s"] += time.perf_counter() - t0
            self.stats["prefills"] += 1
            comp = Completion(rid=r.rid, tenant=r.tenant, tokens=[tok0])
            if r.max_new_tokens <= 1 or tok0 == self.stop_token:
                self.cache.release(r.tenant)
                done[r.rid] = comp
                continue
            slot = self.slots.alloc()
            self.slots.write(slot, page, start_pos=last_idx + 1)
            self._aslot[slot] = aslot
            self._last_tok[slot] = tok0
            self._active[slot] = comp
            self._budget[slot] = r.max_new_tokens - 1

    def _decode(self) -> np.ndarray:
        """One step over every page (free pages too; their output is dropped)."""
        toks = torch.from_numpy(self._last_tok).to(self.device)
        pos = torch.from_numpy(self.slots.pos).to(self.device)
        emb = model_lib.embed_tokens(self.cfg, self.backbone, toks[:, None])
        if "text" in self.bank.data:
            aslots = torch.from_numpy(self._aslot).to(self.device)
            flat = grouped_adapter_apply(self.bank, "text", emb[:, 0, :], aslots,
                                         use_pallas=self.use_pallas_grouped)
            emb = flat[:, None, :]
        lg, _ = model_lib.decode_step(self.cfg, self.backbone, emb, self.slots.state, pos,
                                      moe_group=1)
        return torch.argmax(lg[:, 0, :], dim=-1).cpu().numpy()

    def _step(self, done: Dict[int, Completion]) -> None:
        if not self._active:
            return
        t0 = time.perf_counter()
        nxt = self._decode()
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["decode_steps"] += 1
        self.stats["occupancy_sum"] += len(self._active)
        for slot in sorted(self._active):
            comp = self._active[slot]
            tok = int(nxt[slot])
            comp.tokens.append(tok)
            self.slots.pos[slot] += 1
            self._last_tok[slot] = tok
            self._budget[slot] -= 1
            if self._budget[slot] <= 0 or tok == self.stop_token:
                self.cache.release(comp.tenant)
                self.slots.free(slot)
                self._aslot[slot] = -1
                del self._active[slot]
                del self._budget[slot]
                done[comp.rid] = comp

    def mean_occupancy(self) -> float:
        s = self.stats
        return s["occupancy_sum"] / max(1, s["decode_steps"])


# ---------------------------------------------------------------------------
# the one-request-at-a-time loop: the pre-engine serving path, the baseline
# ---------------------------------------------------------------------------

@torch.no_grad()
def generate_naive(cfg, backbone, requests: List[Request],
                   adapters_by_tenant: Optional[Dict[str, Dict]] = None, *,
                   stop_token: Optional[int] = None) -> Dict[int, Completion]:
    """Serve requests one at a time, one adapter set resident at a time
    (``repro.serving.engine.generate_naive``): unpadded prompts, a cache of
    ``capacity = L + max_new_tokens + 1``, prefill, then one row's
    ``decode_step`` per token with the text adapter applied to each new
    token's embedding in host Python between steps. Tenant ``None`` (or one
    without adapters) takes the identity set, zeros. It runs every family
    the engine runs: the audio family's frames go to ``enc_embeds``, and an
    MoE layer routes the one row as one group, the same for ``moe_group``
    None and 1.

    One deliberate difference: the JAX package applies the per-token text
    adapter on its jnp path (no ``use_pallas``, ``engine.py:334``); the port
    passes ``use_pallas=cfg.use_pallas``, so that on the card that step runs
    the LoRA kernel and no plain version sits on the path. On the CPU both
    take the plain version.
    """
    adapters_by_tenant = adapters_by_tenant or {}
    device = backbone["embed"]["table"].device
    identity = {mod: {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
                      for k, v in a.items()}
                for mod, a in nano.init_nanoedge(torch.Generator().manual_seed(0), cfg).items()}
    kw = dict(rank=cfg.adapter.rank, alpha=cfg.adapter.alpha, use_pallas=cfg.use_pallas)
    done: Dict[int, Completion] = {}
    for r in requests:
        adapters = adapters_by_tenant.get(r.tenant, identity)
        prompt = torch.from_numpy(np.asarray(r.prompt, np.int64)[None]).to(device)
        patches = None
        if r.patches is not None:
            patches = torch.as_tensor(np.asarray(r.patches, np.float32)[None], device=device)
        batch = Batch(tokens=prompt, labels=torch.zeros_like(prompt),
                      mask=torch.zeros(prompt.shape, dtype=torch.float32, device=device),
                      patches=patches)
        embeds, positions, _, _, enc = nano.nanoedge_forward(cfg, backbone, adapters, batch)
        n = embeds.shape[1]
        state, hidden = model_lib.prefill(cfg, backbone, embeds, positions,
                                          n + r.max_new_tokens + 1, enc_embeds=enc)
        tok = int(torch.argmax(model_lib.logits(cfg, backbone, hidden[:, -1:])[0, 0]))
        comp = Completion(rid=r.rid, tenant=r.tenant, tokens=[tok])
        for step in range(r.max_new_tokens - 1):
            if comp.tokens[-1] == stop_token:
                break
            emb = model_lib.embed_tokens(cfg, backbone,
                                         torch.tensor([[tok]], dtype=torch.long, device=device))
            if "text" in adapters:
                emb = nano.nano_adapter_apply(adapters["text"], emb, **kw)
            lg, state = model_lib.decode_step(cfg, backbone, emb, state, n + step)
            tok = int(torch.argmax(lg[0, 0]))
            comp.tokens.append(tok)
        done[r.rid] = comp
    return done
