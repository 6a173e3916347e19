"""Composable client→server upload transforms, the wire pipeline
(``repro.strategies.transforms``).

Each transform receives the candidate upload θ and the global reference and
returns the θ the server will see, its own carried per-client state (an
error-feedback residual) and the bytes that cross the wire, which the engine
logs as ``param_up_wire``:

    theta, state, wire = transform.apply(ctx, theta, global_ref, state)

``wire=None`` means "size unchanged" (clip + noise). ``encode`` produces a
self-describing :class:`WireMessage` stamped with (codec, version) and its
exact byte count; ``decode_wire`` dispatches on the stamp and refuses
unknown codecs and versions. ``apply`` is encode then decode, so the wire
bytes are by construction the size of the message that crossed.
``state_template`` gives the structure of the carried state a checkpoint
restores into (None: stateless). The payloads are the JAX package's, bit
for bit on equal inputs; only the DP noise comes from a ``torch.Generator``
(seeded per (1234 + cid, round)), since ``jax.random`` draws cannot be
reproduced.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.utils import tree_add, tree_bytes, tree_map, tree_sub, tree_zeros_like

# Version of every codec's on-the-wire encoding; decode_wire rejects others.
WIRE_FORMAT_VERSION = 1


class TransformCtx(NamedTuple):
    """Where in the protocol the transform is running."""

    cid: int
    round_idx: int


class WireMessage(NamedTuple):
    """A self-describing upload: ``nbytes`` is what the comm log records as
    ``param_up_wire``; ``payload`` is codec-specific (trees of tensors)."""

    codec: str
    version: int
    payload: Any
    nbytes: int


_DECODERS: Dict[str, Callable] = {}


def _codec(name: str):
    """Register ``fn(msg, global_ref) -> theta`` as the decoder of a codec."""

    def deco(fn):
        _DECODERS[name] = fn
        return fn

    return deco


def decode_wire(msg: WireMessage, global_ref):
    """Server-side decode: dispatch on the (codec, version) stamp; an unknown
    stamp is a protocol error, never a silent fallback."""
    if msg.version != WIRE_FORMAT_VERSION:
        raise ValueError(f"wire message {msg.codec!r} has format version {msg.version}, "
                         f"this code speaks v{WIRE_FORMAT_VERSION}; refusing to decode")
    dec = _DECODERS.get(msg.codec)
    if dec is None:
        raise ValueError(f"unknown wire codec {msg.codec!r}; known: "
                         f"{', '.join(sorted(_DECODERS))}")
    return dec(msg, global_ref)


@_codec("identity")
@_codec("dp_fp32")
def _decode_dense(msg, global_ref):
    return msg.payload  # a dense f32 tree: the payload is the upload


@_codec("int8_ef")
def _decode_int8(msg, global_ref):
    from repro_torch.core.compression import QuantizedDelta, dequantize_delta

    q = QuantizedDelta(payload=msg.payload["q"], scales=msg.payload["scales"],
                       wire_bytes=msg.nbytes)
    return tree_add(global_ref, dequantize_delta(q))


def _scatter_topk(ref_leaf, packed):
    flat = torch.zeros(ref_leaf.numel(), dtype=ref_leaf.dtype, device=ref_leaf.device)
    flat[packed["idx"].long()] = packed["vals"]
    return flat.reshape(ref_leaf.shape)


def _map_packed(fn, ref, packed):
    """``fn(ref_leaf, {vals, idx})`` over ``ref``'s leaves: each packed dict
    arrives whole at its leaf's place."""
    if isinstance(ref, dict):
        return {k: _map_packed(fn, v, packed[k]) for k, v in ref.items()}
    return fn(ref, packed)


@_codec("topk")
def _decode_topk(msg, global_ref):
    return tree_add(global_ref, _map_packed(_scatter_topk, global_ref, msg.payload))


@dataclass(frozen=True)
class UpdateTransform:
    """Identity transform; subclass and override ``encode`` (and set
    ``wire_transparent = False`` when the wire size differs from the dense
    tree's, so ``apply`` reports the encoded size)."""

    # True: apply() reports wire=None ("size unchanged"); the engine takes the
    # dense tree's size unless a later size-changing transform overrides it.
    wire_transparent = True

    def encode(self, ctx: TransformCtx, theta, global_ref, state) -> Tuple[WireMessage, Any]:
        return WireMessage(codec="identity", version=WIRE_FORMAT_VERSION, payload=theta,
                           nbytes=tree_bytes(theta)), state

    def state_template(self, global_ref):
        """Structure of this transform's carried per-client state (None:
        stateless, a checkpoint has nothing to restore)."""
        return None

    def apply(self, ctx: TransformCtx, theta, global_ref, state):
        msg, state = self.encode(ctx, theta, global_ref, state)
        return decode_wire(msg, global_ref), state, (None if self.wire_transparent
                                                     else msg.nbytes)


def dp_generator(ctx: TransformCtx, device) -> torch.Generator:
    """The DP noise stream of one (client, round), independent of training,
    so DP on or off never moves the learning trajectory."""
    from repro_torch.strategies.sampling import round_seed

    return torch.Generator(device=device).manual_seed(round_seed(1234 + ctx.cid,
                                                                 ctx.round_idx))


@dataclass(frozen=True)
class ClipNoiseDP(UpdateTransform):
    """Client-level DP: L2-clip the delta to ``clip_norm`` and add Gaussian
    noise of std ``noise_mult·clip_norm`` (McMahan et al. 2018). Wire size
    unchanged."""

    clip_norm: float = 1.0
    noise_mult: float = 0.0

    def encode(self, ctx, theta, global_ref, state):
        from repro_torch.core.privacy import privatize_update
        from repro_torch.utils import tree_leaves

        gen = dp_generator(ctx, tree_leaves(theta)[0].device)
        theta = privatize_update(gen, theta, global_ref, clip_norm=self.clip_norm,
                                 noise_mult=self.noise_mult)
        return WireMessage(codec="dp_fp32", version=WIRE_FORMAT_VERSION, payload=theta,
                           nbytes=tree_bytes(theta)), state


@dataclass(frozen=True)
class Int8EFQuant(UpdateTransform):
    """int8 delta quantization with error feedback (≈4× smaller uploads); the
    residual is carried in ``state`` into the next round."""

    wire_transparent = False

    def encode(self, ctx, theta, global_ref, state):
        from repro_torch.core.compression import compress_update, init_error_feedback

        err = state if state is not None else init_error_feedback(theta)
        q, err = compress_update(theta, global_ref, err)
        return WireMessage(codec="int8_ef", version=WIRE_FORMAT_VERSION,
                           payload={"q": q.payload, "scales": q.scales},
                           nbytes=q.wire_bytes), err

    def state_template(self, global_ref):
        from repro_torch.core.compression import init_error_feedback

        return init_error_feedback(global_ref)


@dataclass(frozen=True)
class TopKSparsify(UpdateTransform):
    """Keep exactly the ``frac`` largest-magnitude delta entries of each leaf,
    with error feedback; wire = kept values + int32 indices."""

    frac: float = 0.1
    wire_transparent = False

    def encode(self, ctx, theta, global_ref, state):
        delta = tree_sub(theta, global_ref)
        if state is not None:
            delta = tree_add(delta, state)
        wire = 0

        def keep(x):
            nonlocal wire
            k = max(1, int(round(self.frac * x.numel())))
            wire += k * (x.element_size() + 4)
            # by index: exactly k entries survive even under ties, the lower
            # index first among equal magnitudes as ``jax.lax.top_k`` keeps
            # them (AdamW's first steps make many exact ties): a stable sort,
            # where ``torch.topk`` leaves the order of ties open
            flat = x.reshape(-1)
            order = torch.sort(flat.abs(), descending=True, stable=True).indices
            idx = order[:k].to(torch.int32)
            return {"vals": flat[idx.long()], "idx": idx}

        packed = tree_map(keep, delta)
        msg = WireMessage(codec="topk", version=WIRE_FORMAT_VERSION, payload=packed,
                          nbytes=wire)
        # error feedback: exactly what the sparse reconstruction drops
        return msg, tree_sub(delta, _map_packed(_scatter_topk, delta, packed))

    def state_template(self, global_ref):
        return tree_zeros_like(global_ref)


def default_transforms(hp) -> Tuple[UpdateTransform, ...]:
    """The ``HyperParams``-driven chain: DP first, then int8 + EF."""
    chain = []
    if hp.dp_clip > 0.0:
        chain.append(ClipNoiseDP(clip_norm=hp.dp_clip, noise_mult=hp.dp_noise))
    if hp.compress_uploads:
        chain.append(Int8EFQuant())
    return tuple(chain)
