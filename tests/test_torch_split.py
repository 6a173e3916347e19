"""The port's split-learning runtime (``repro_torch.core.split``) against the
JAX package's (``repro.core.split``).

Smoke configs in f32 on the CPU; the JAX package draws the backbone and the
adapters' ``down``, exported through ``repro_torch.interop``, and ``up``
comes from a numpy seed (off identity, so both halves carry gradient), as
do the batches.
Loss and adapter gradients are held against JAX ``split_train_grads`` at
1e-5 of ‖ref‖∞, and the port's split against its own fused gradient of
``fednano_loss`` at the same bound. The traffic is counted in bytes: equal
to JAX's measured traffic on the three parity archs, and on the six archs
of ``tests/test_split.py`` equal to the analytic count of both packages
(which the JAX tests hold equal to JAX's measured traffic).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import Batch as JBatch
from repro.core import adapters as jnano
from repro.core.split import split_activation_bytes_per_step as jax_split_bytes
from repro.core.split import split_train_grads as jax_split_train_grads
from repro.models import model as jmodel
from repro_torch import interop
from repro_torch.configs import get_smoke_config
from repro_torch.core import split
from repro_torch.core.types import Batch
from repro_torch.core import adapters as nano
from repro_torch.core import client as client_lib
from repro_torch.core.adapters import init_nanoedge
from repro_torch.models.model import init_backbone
from repro_torch.models.vision_stub import num_patches
from repro_torch.utils import tree_leaves

from test_torch_training import assert_tree_close, one_torch_thread, rel_err  # noqa: F401

PARITY_ARCHS = ["h2o-danube-1.8b", "llava-1.5-7b", "whisper-base"]
TRAFFIC_ARCHS = ["llava-1.5-7b", "minigpt4-7b", "qwen2-vl-72b", "whisper-base",
                 "h2o-danube-1.8b", "mamba2-130m"]
B, S = 2, 12


def _batch_np(cfg, seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    patches = None
    if cfg.frontend_dim:
        m = cfg.enc_seq_len if cfg.family == "audio" else num_patches(cfg)
        patches = rng.standard_normal((b, m, cfg.frontend_dim)).astype(np.float32)
    return dict(tokens=rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
                labels=rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
                mask=(rng.random((b, s)) < 0.7).astype(np.float32), patches=patches)


def _port_batch(arrays):
    return Batch(tokens=torch.from_numpy(arrays["tokens"]).long(),
                 labels=torch.from_numpy(arrays["labels"]).long(),
                 mask=torch.from_numpy(arrays["mask"]),
                 patches=None if arrays["patches"] is None else torch.from_numpy(arrays["patches"]))


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """The JAX-drawn backbone and (off-identity) adapters, both packages'
    views of them, and one numpy batch."""
    jcfg = jax_smoke_config(arch)
    cfg = get_smoke_config(arch)
    backbone = jax.tree.map(np.asarray, jmodel.init_backbone(jax.random.PRNGKey(11), jcfg))
    # ``up`` drawn off zero (a constant ``up`` would meet LayerNorm's
    # mean-free input gradient and leave ``down``'s gradient at rounding noise)
    rng = np.random.default_rng(12)
    adapters = {m: {"down": np.asarray(a["down"]),
                    "up": (rng.standard_normal(a["up"].shape) * 0.05).astype(np.float32)}
                for m, a in jnano.init_nanoedge(jax.random.PRNGKey(12), jcfg).items()}
    return jcfg, cfg, backbone, adapters, _batch_np(cfg)


@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_split_matches_reference_and_fused(arch):
    jcfg, cfg, backbone_np, adapters_np, arrays = _setup(arch)
    jbatch = JBatch(**{k: None if v is None else jnp.asarray(v) for k, v in arrays.items()})
    jloss, jgrads, jtraffic = jax_split_train_grads(
        jcfg, jax.tree.map(jnp.asarray, backbone_np), jax.tree.map(jnp.asarray, adapters_np),
        jbatch)

    backbone = interop.backbone_from_numpy(cfg, backbone_np, "cpu")
    adapters = interop.adapters_from_numpy(adapters_np, "cpu")
    batch = _port_batch(arrays)
    loss, grads, traffic = split.split_train_grads(cfg, backbone, adapters, batch)
    assert rel_err(loss, jloss) <= 1e-5
    assert_tree_close(grads, jgrads, 1e-5, f"{arch} split grads vs reference")
    assert traffic == {k: int(v) for k, v in jtraffic.items()}
    assert traffic["act_up"] > 0 and traffic["act_down"] == traffic["act_up"]

    floss, _, fgrads = client_lib.value_and_grad(
        lambda a: nano.fednano_loss(cfg, backbone, a, batch), adapters)
    assert rel_err(loss, floss) <= 1e-5
    assert_tree_close(grads, interop.adapters_to_numpy(fgrads), 1e-5, f"{arch} split vs fused")
    # the backbone stays frozen, the caller's adapters untouched
    assert not any(t.requires_grad for t in tree_leaves(backbone))
    assert not any(t.requires_grad for t in tree_leaves(adapters))


def test_server_step_differentiates_the_inputs_only():
    """The server half: (loss, d_embeds, d_enc) by autograd with respect to the
    wire tensors, the audio family's encoder stream included; the client's
    vjp seeded with them gives the split gradients."""
    jcfg, cfg, backbone_np, adapters_np, arrays = _setup("whisper-base")
    backbone = interop.backbone_from_numpy(cfg, backbone_np, "cpu")
    adapters = interop.adapters_from_numpy(adapters_np, "cpu")
    (embeds, positions, labels, mask, enc), vjp = split.client_forward_vjp(
        cfg, backbone, adapters, _port_batch(arrays))
    assert not embeds.requires_grad and not enc.requires_grad
    assert enc.shape == (B, cfg.enc_seq_len, cfg.d_model)
    loss, d_embeds, d_enc = split.make_server_step(cfg)(backbone, embeds, positions, labels,
                                                        mask, enc)
    assert d_embeds.shape == embeds.shape and d_enc.shape == enc.shape
    assert float(d_enc.abs().max()) > 0
    (grads,) = vjp((d_embeds, d_enc))
    _, want, _ = split.split_train_grads(cfg, backbone, adapters, _port_batch(arrays))
    for g, w in zip(tree_leaves(grads), tree_leaves(want)):
        assert torch.equal(g, w)
    wire = split.client_forward(cfg, backbone, adapters, _port_batch(arrays))
    assert torch.equal(wire[0], embeds) and torch.equal(wire[4], enc)


@pytest.mark.parametrize("arch", TRAFFIC_ARCHS)
def test_activation_traffic_matches_analytic(arch):
    """Measured wire bytes of the port's split step equal the port's and the
    JAX package's analytic counts on every arch: the encoder stream (image
    prefix, audio memory) counted with the text embeddings."""
    cfg = get_smoke_config(arch)
    backbone = init_backbone(cfg, seed=0, device="cpu")
    adapters = init_nanoedge(torch.Generator().manual_seed(1), cfg)
    _, _, traffic = split.split_train_grads(cfg, backbone, adapters, _port_batch(_batch_np(cfg)))
    est = split.split_activation_bytes_per_step(cfg, B, S)
    want = jax_split_bytes(jax_smoke_config(arch), B, S)
    assert traffic == est == want, (arch, traffic, est, want)


def test_activation_traffic_text_only_override():
    """``n_patches=0`` gives the text-only wire cost on a multimodal arch,
    as the JAX package's, and the measured traffic of a batch without
    images."""
    cfg = get_smoke_config("llava-1.5-7b")
    est = split.split_activation_bytes_per_step(cfg, B, S, n_patches=0)
    assert est["act_up"] == B * S * cfg.d_model * 4
    assert est == jax_split_bytes(jax_smoke_config("llava-1.5-7b"), B, S, n_patches=0)
    arrays = dict(_batch_np(cfg), patches=None)
    backbone = init_backbone(cfg, seed=0, device="cpu")
    adapters = init_nanoedge(torch.Generator().manual_seed(1), cfg)
    _, grads, traffic = split.split_train_grads(cfg, backbone, adapters, _port_batch(arrays))
    assert traffic == est
    # the image adapter sees no input: a zero gradient, as jax.vjp gives it
    assert all(float(t.abs().max()) == 0.0 for t in grads["image"].values())
