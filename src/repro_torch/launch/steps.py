"""The three step functions of the launch layer, one per input-shape kind
(PyTorch counterpart of ``repro.launch.steps``), and their abstract inputs.

  train_step    FedNano's training unit: NanoEdge forward (client half) ->
                frozen backbone forward and backward (server half) -> AdamW
                on the adapters only, and the squared gradients a Fisher pass
                accumulates. The backbone's tensors never require grad.
  prefill_step  forward over the prompt -> (decode state, last logits).
  decode_step   one token against a seq_len cache or state; the client's
                text NanoAdapter on the new token's embedding first.

For the vlm and audio families the batch carries stub patch (frame)
embeddings, adapted client-side within the same step, as in the JAX
package. The ``*_specs`` functions are the counterpart of
``jax.ShapeDtypeStruct`` / ``jax.eval_shape``: they run the real init
functions on the ``meta`` device, so every leaf has its shape and dtype and
nothing is allocated. ``exec_config`` and ``shape_supported`` are the
dry-run's workload policy.
"""
from __future__ import annotations

import torch

from repro_torch.core import adapters as adapters_lib
from repro_torch.core.client import value_and_grad
from repro_torch.core.types import Batch
from repro_torch.models import model as model_lib
from repro_torch.models.layers import make_generator, torch_dtype
from repro_torch.models.vision_stub import num_patches
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.utils import tree_map

META = torch.device("meta")
# The JAX package's execution switches that the port has no counterpart of:
# ``scan_layers`` sets only the size of the HLO, and ``seq_parallel`` and
# ``ctx_parallel_attn`` shard over a device mesh that one process does not
# have; an override names them and fails. ``remat`` is the port's too
# (``ModelConfig.remat``): each layer keeps its input only and the backward
# runs the layer's forward once more.
UNPORTED_SWITCHES = ("scan_layers", "seq_parallel", "ctx_parallel_attn")


def make_train_step(cfg, hp_lr: float = 1e-3):
    """(backbone, adapters, opt_state, batch) -> (adapters', opt_state', loss, fisher_sq)."""

    def train_step(backbone, adapters, opt_state, batch: Batch):
        loss, _, grads = value_and_grad(
            lambda adp: adapters_lib.fednano_loss(cfg, backbone, adp, batch), adapters,
            allow_unused=True)
        new_adapters, new_opt = adamw_update(grads, opt_state, adapters, lr=hp_lr)
        fisher_sq = tree_map(lambda g: g.float().square(), grads)
        return new_adapters, new_opt, loss, fisher_sq

    return train_step


def make_prefill_step(cfg, capacity: int):
    """(backbone, adapters, batch) -> (state, last_logits (B, 1, V))."""

    @torch.no_grad()
    def prefill_step(backbone, adapters, batch: Batch):
        embeds, positions, _, _, enc = adapters_lib.nanoedge_forward(cfg, backbone, adapters,
                                                                     batch)
        state, hidden = model_lib.prefill(cfg, backbone, embeds, positions, capacity,
                                          enc_embeds=enc)
        return state, model_lib.logits(cfg, backbone, hidden[:, -1:, :])

    return prefill_step


def make_decode_step(cfg):
    """(backbone, adapters, state, token (B,) int, pos () or (B,) int) ->
    (logits (B, 1, V), state updated in place).

    The client-side text NanoAdapter runs on the new token's embedding
    before it enters the backbone (split serving), through
    ``nano_adapter_apply``: under ``cfg.use_pallas`` the LoRA kernel on B
    rows. The B rows route an MoE layer as one group, as JAX's
    ``model.decode_step`` on a batch does.
    """

    @torch.no_grad()
    def decode_step(backbone, adapters, state, token, pos):
        emb = model_lib.embed_tokens(cfg, backbone, token[:, None])  # (B, 1, D)
        if "text" in adapters:
            emb = adapters_lib.nano_adapter_apply(
                adapters["text"], emb, rank=cfg.adapter.rank, alpha=cfg.adapter.alpha,
                use_pallas=cfg.use_pallas)
        if pos.dim() == 0:
            pos = pos.expand(token.shape[0])
        return model_lib.decode_step(cfg, backbone, emb, state, pos)

    return decode_step


# ---------------------------------------------------------------------------
# abstract inputs: meta tensors, no allocation
# ---------------------------------------------------------------------------

def text_seq_len(cfg, seq_len: int) -> int:
    """Text tokens such that image patches + text == seq_len in total."""
    if cfg.family == "audio":
        return seq_len  # decoder positions; the encoder stream is separate
    if cfg.frontend_dim:
        return max(seq_len - num_patches(cfg), 8)
    return seq_len


def batch_specs(cfg, batch: int, seq_len: int, device=META) -> Batch:
    """The train/prefill Batch: int32 tokens and labels, f32 mask, and stub
    patches in the config's dtype, as JAX's ``batch_specs``."""
    s_text = text_seq_len(cfg, seq_len)
    patches = None
    if cfg.frontend_dim:
        patches = torch.empty((batch, num_patches(cfg), cfg.frontend_dim),
                              dtype=torch_dtype(cfg.dtype), device=device)
    return Batch(tokens=torch.empty((batch, s_text), dtype=torch.int32, device=device),
                 labels=torch.empty((batch, s_text), dtype=torch.int32, device=device),
                 mask=torch.empty((batch, s_text), dtype=torch.float32, device=device),
                 patches=patches)


def input_specs(cfg, shape_cfg, device=META):
    """Every model input of a workload, by kind: train and prefill
    {"batch"}; decode {"state" (capacity seq_len), "token" (B,) int32,
    "pos" () int32}."""
    b, s = shape_cfg.global_batch, shape_cfg.seq_len
    if shape_cfg.kind in ("train", "prefill"):
        return {"batch": batch_specs(cfg, b, s, device)}
    return {"state": model_lib.init_state(cfg, b, s, torch_dtype(cfg.dtype), device),
            "token": torch.empty((b,), dtype=torch.int32, device=device),
            "pos": torch.empty((), dtype=torch.int32, device=device)}


def adapter_specs(cfg, device=META):
    return adapters_lib.init_nanoedge(make_generator(device, 0), cfg)


def backbone_specs(cfg, device=META):
    return model_lib.init_backbone(cfg, seed=0, device=device)


def opt_state_specs(cfg, device=META):
    return adamw_init(adapter_specs(cfg, device))


# ---------------------------------------------------------------------------
# workload policy (shared by the dry-run and the tests)
# ---------------------------------------------------------------------------

def shape_supported(cfg, shape_cfg) -> tuple[bool, str]:
    """long_500k needs sub-quadratic sequence mixing."""
    if shape_cfg.name == "long_500k":
        if cfg.family == "audio":
            return False, "enc-dec audio backbone: fixed 1500-frame encoder context"
        if not cfg.subquadratic:
            return False, "pure full-attention arch (no SWA/block-sparse variant)"
    return True, ""


def check_overrides(overrides) -> None:
    """Raise for an override of a JAX execution switch the port lacks."""
    bad = sorted(set(overrides or ()) & set(UNPORTED_SWITCHES))
    if bad:
        raise ValueError(f"the port has no execution switch {bad}: the JAX package's HLO "
                         "and TPU mesh options have no counterpart here")


def exec_config(cfg, shape_cfg, mode: str, overrides: dict | None = None):
    """The config a dry-run executes (``steps.py:171-198``).

    mode "full": query-chunked attention (``attn_chunk`` 1,024) for train and
    prefill, so the plain path holds (B, H, 1024, S) logits at a time.
    mode "roofline": no chunking; ``run_roofline`` counts reduced depths and
    extrapolates. ``remat`` passes through as the config has it (on in every
    full config), as JAX's does, so a train step's count includes the
    recompute; ``--override remat=false`` turns it off. An override of a
    switch the port lacks (``UNPORTED_SWITCHES``) raises and names it.
    """
    check_overrides(overrides)
    kw = {}
    if mode == "full":
        if shape_cfg.kind != "decode":
            kw["attn_chunk"] = 1024
    else:
        kw["attn_chunk"] = None
    kw.update(overrides or {})
    return cfg.with_(**kw)


def _depth_points(cfg):
    """Depths the roofline counts and how it extrapolates to full depth."""
    if cfg.family == "audio":
        return "exact", [cfg.n_layers]          # 6 + 6 whisper: count all of it
    if cfg.family == "ssm":
        return "exact", [cfg.n_layers]          # 24 small layers: count all of it
    if cfg.family == "hybrid":
        return "hybrid", [3, 6, 8]              # 1 triple, 2 triples, 2 triples + 2 rec
    return "linear", [2, 4]
