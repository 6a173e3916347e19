"""The port's ``remat`` (``ModelConfig.remat``: each layer body of a training
forward under ``torch.utils.checkpoint``) against the JAX package's
``jax.checkpoint`` of its scanned bodies.

Smoke configs in f32 on the CPU with ``remat=True`` in both packages; the
port draws the backbone and the adapters' ``down``, exported to the JAX
package's layout through ``repro_torch.interop``, and ``up`` comes from a
numpy seed (off zero, so ``down`` carries gradient), as do the batches. Each family's loss and
adapter gradients are held against ``jax.grad`` at 1e-5 of ‖ref‖∞; the
port's remat on against off to the bit, on the model, the cohort (vmap)
engine, the split step and one sharded round. A counter on each layer body
shows the recompute: two calls a body in a training step with remat, one
without it and one under ``torch.no_grad`` or ``inference_mode``.
``chip_smoke.py``'s MoE route record and replay see the forward's calls only.
"""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import Batch as JBatch
from repro.core import adapters as jnano
from repro_torch import interop
from repro_torch.configs import get_smoke_config
from repro_torch.core import HyperParams, init_server, run_federated, split
from repro_torch.core import adapters as nano
from repro_torch.core import client as client_lib
from repro_torch.core.adapters import init_nanoedge
from repro_torch.data import make_federated_data
from repro_torch.models import encdec, transformer
from repro_torch.models.layers import make_generator
from repro_torch.models.model import init_backbone
from repro_torch.utils import tree_leaves

from test_torch_split import _batch_np, _port_batch
from test_torch_training import assert_tree_close, one_torch_thread, rel_err  # noqa: F401

# every family: dense h2o with its window (the smoke window of 64 crossed at
# S = 80), vlm llava, moe llama4 (shared expert) and grok (softcap, GELU),
# ssm mamba2 (S = 40 crosses its SSD chunk of 32), hybrid recurrentgemma at
# 5 layers (one triple and two trailing rec layers), audio whisper
ARCHS = {"h2o-danube-1.8b": ({}, 80), "llava-1.5-7b": ({}, 12),
         "llama4-scout-17b-a16e": ({}, 12), "grok-1-314b": ({}, 12),
         "mamba2-130m": ({}, 40), "recurrentgemma-9b": (dict(n_layers=5), 80),
         "whisper-base": ({}, 12)}
B = 2
TOL = 1e-5


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """Both packages' configs with remat on, the backbone the port draws
    from seed 21 exported to the JAX package's stacked layout (numpy), the
    adapters (``down`` as the port draws it, ``up`` from a numpy seed), and
    one numpy batch."""
    over, s = ARCHS[arch]
    jcfg = jax_smoke_config(arch, **over).with_(remat=True)
    cfg = get_smoke_config(arch, **over).with_(remat=True)
    backbone = interop.backbone_to_numpy(init_backbone(cfg, seed=21, device="cpu"), cfg)
    rng = np.random.default_rng(22)
    adapters = {m: {"down": a["down"].numpy(),
                    "up": (rng.standard_normal(a["up"].shape) * 0.05).astype(np.float32)}
                for m, a in init_nanoedge(make_generator("cpu", 22), cfg).items()}
    return jcfg, cfg, backbone, adapters, _batch_np(cfg, seed=23, b=B, s=s)


def _port(arch):
    _, cfg, backbone, adapters, arrays = _setup(arch)
    return (cfg, interop.backbone_from_numpy(cfg, backbone, "cpu"),
            interop.adapters_from_numpy(adapters, "cpu"), _port_batch(arrays))


def _loss_and_grads(cfg, backbone, adapters, batch):
    loss, _, grads = client_lib.value_and_grad(
        lambda a: nano.fednano_loss(cfg, backbone, a, batch), adapters, allow_unused=True)
    return loss, grads


def _bits_equal(a, b, what):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb), what
    for x, y in zip(la, lb):
        assert torch.equal(x, y), what


@pytest.mark.parametrize("arch", list(ARCHS))
def test_remat_matches_reference(arch):
    """Loss and adapter gradients with remat on, the port (its kernels'
    plain versions, ``use_pallas``) against JAX's ``jax.grad`` through
    ``jax.checkpoint`` (jnp path), at 1e-5 of ‖ref‖∞."""
    jcfg, _, backbone_np, adapters_np, arrays = _setup(arch)
    jbatch = JBatch(**{k: None if v is None else jnp.asarray(v) for k, v in arrays.items()})
    jadapters = jax.tree.map(jnp.asarray, adapters_np)
    # XLA's CPU backend at optimization level 0 compiles in about half the time
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda a: jnano.fednano_loss(jcfg, jax.tree.map(jnp.asarray, backbone_np), a, jbatch),
        has_aux=True)).lower(jadapters).compile(
            compiler_options={"xla_backend_optimization_level": 0})(jadapters)
    cfg, backbone, adapters, batch = _port(arch)
    loss, grads = _loss_and_grads(cfg.with_(use_pallas=True), backbone, adapters, batch)
    assert rel_err(loss, jloss) <= TOL
    assert_tree_close(grads, jgrads, TOL, f"{arch} remat grads vs reference")


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "pallas"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_remat_on_equals_off_to_the_bit(arch, use_pallas):
    """The recompute runs the same operations on the same inputs, so the
    loss and every adapter gradient are those of the run without remat."""
    cfg, backbone, adapters, batch = _port(arch)
    cfg = cfg.with_(use_pallas=use_pallas)
    on = _loss_and_grads(cfg, backbone, adapters, batch)
    off = _loss_and_grads(cfg.with_(remat=False), backbone, adapters, batch)
    assert torch.equal(on[0], off[0])
    _bits_equal(on[1], off[1], f"{arch} remat on vs off")


# the layer bodies of each stack, by module and name, and how many a smoke
# config has: dense/vlm/moe layers, ssm layers, hybrid triples and trailing
# rec layers, whisper's encoder and decoder layers
BODIES = {"h2o-danube-1.8b": {(transformer, "_layer_body"): 2},
          "llava-1.5-7b": {(transformer, "_layer_body"): 2},
          "llama4-scout-17b-a16e": {(transformer, "_layer_body"): 2},
          "grok-1-314b": {(transformer, "_layer_body"): 2},
          "mamba2-130m": {(transformer, "ssm_body"): 2},
          "recurrentgemma-9b": {(transformer, "_triple_body"): 1,
                                (transformer, "_rec_body"): 2},
          "whisper-base": {(encdec, "_enc_layer"): 2, (encdec, "_dec_body"): 2}}
# (remat, how the loss runs, calls of each body)
RUNS = [(True, "grad", 2), (False, "grad", 1), (True, "no_grad", 1),
        (True, "inference_mode", 1)]


@pytest.mark.parametrize("remat,mode,calls", RUNS,
                         ids=[f"{'on' if r else 'off'}-{m}" for r, m, _ in RUNS])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_each_body_runs_twice_under_remat(arch, remat, mode, calls, monkeypatch):
    """A counter on every layer body: with remat and grad the backward calls
    each body once more, with ``transformer.recomputing()`` true; without
    remat, or with grad off, once, with it false."""
    cfg, backbone, adapters, batch = _port(arch)
    cfg = cfg.with_(remat=remat, use_pallas=True)
    counts, recomputed = {}, {}
    for (mod, name), n in BODIES[arch].items():
        counts[name] = recomputed[name] = 0

        def counted(*args, _fn=getattr(mod, name), _name=name):
            counts[_name] += 1
            recomputed[_name] += transformer.recomputing()
            return _fn(*args)

        monkeypatch.setattr(mod, name, counted)
    if mode == "grad":
        _loss_and_grads(cfg, backbone, adapters, batch)
    else:
        with getattr(torch, mode)():
            nano.fednano_loss(cfg, backbone, adapters, batch)
    assert counts == {name: n * calls for (_, name), n in BODIES[arch].items()}
    assert recomputed == {name: n * (calls - 1) for (_, name), n in BODIES[arch].items()}
    assert not transformer.recomputing()


def _chip_smoke():
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "grok-1-314b"])
def test_chip_smoke_routes_under_remat(arch):
    """``chip_smoke.py``'s MoE route record and replay under remat: a
    training step records one routing a MoE layer, the forward's, as
    without remat; a replay of another batch's routing gives the recompute
    the choices its forward took, so the loss and gradients with remat are
    those without, to the bit."""
    cs = _chip_smoke()
    cfg, backbone, adapters, batch = _port(arch)
    on, off = cfg.with_(use_pallas=True), cfg.with_(use_pallas=True, remat=False)
    other = _port_batch(_batch_np(cfg, seed=24, b=B, s=ARCHS[arch][1]))
    with cs.recorded_routes() as rec:
        _loss_and_grads(on, backbone, adapters, other)
    with cs.recorded_routes() as rec_off:
        _loss_and_grads(off, backbone, adapters, other)
    assert len(rec) == len(rec_off) > 0
    assert all(torch.equal(a.idx, b.idx) for a, b in zip(rec, rec_off))
    runs = {}
    for c in (on, off):
        with cs.replayed_routes(rec) as own:
            runs[c.remat] = _loss_and_grads(c, backbone, adapters, batch)
        assert len(own) == len(rec)
    assert any(not torch.equal(a.idx, b.idx) for a, b in zip(own, rec))  # a real replay
    assert torch.equal(runs[True][0], runs[False][0])
    _bits_equal(runs[True][1], runs[False][1], f"{arch} replayed routes, remat on vs off")


# ---------------------------------------------------------------------------
# the cohort engine, the split step and the sharded engine: remat on vs off
# ---------------------------------------------------------------------------

HP = dict(lr=5e-3, local_steps=2, fisher_batches=1)
DATA = dict(n_clients=3, examples_per_client=8, alpha=100.0, batch_size=2, seq_len=12, seed=0)


def _run(cfg, engine, **kw):
    train_b, eval_b, _ = make_federated_data(cfg, device="cpu", **DATA)
    return run_federated(0, cfg, train_b, eval_b, strategy="fednano", rounds=1,
                         hp=HyperParams(**HP), use_pallas=True, engine=engine, device="cpu",
                         server=init_server(cfg, seed=0, device="cpu"), **kw)


def _runs_bit_equal(a, b, what):
    assert a.round_metrics == b.round_metrics, what
    assert a.comm_totals == b.comm_totals, what
    _bits_equal(a.server.global_adapters, b.server.global_adapters, what)
    for ca, cb in zip(a.clients, b.clients):
        _bits_equal(ca.adapters, cb.adapters, what)
        _bits_equal(ca.fisher, cb.fisher, what)


ENGINE_CASES = [("llava-1.5-7b", "vmap", {}), ("llama4-scout-17b-a16e", "vmap", {}),
                ("mamba2-130m", "vmap", {}), ("llava-1.5-7b", "sharded", dict(devices=2)),
                ("llava-1.5-7b", "sharded", dict(devices=2, overlap=False))]


@pytest.mark.parametrize("arch,engine,kw", ENGINE_CASES,
                         ids=[f"{a.split('-')[0]}-{e}{'-no-overlap' if 'overlap' in k else ''}"
                              for a, e, k in ENGINE_CASES])
def test_engine_round_remat_on_equals_off(arch, engine, kw):
    """One FedNano round of 3 clients, kernels' plain versions on: the vmap
    engine's folded pass (``clients=K``, MoE groups inside each client, the
    SSD scan's backward nested in the recompute) and the sharded engine on
    two CPU shards, with its two chunks in flight and without, equal to the
    bit with remat on and off."""
    cfg = get_smoke_config(arch).with_(use_pallas=True)
    _runs_bit_equal(_run(cfg.with_(remat=True), engine, **kw),
                    _run(cfg.with_(remat=False), engine, **kw), f"{arch} {engine} {kw}")


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "mamba2-130m", "whisper-base"])
def test_split_step_remat_on_equals_off(arch):
    """The split step's server half differentiates the wire tensors through
    the checkpointed bodies; loss, gradients and traffic equal to the bit,
    and equal to the fused gradient at 1e-5."""
    cfg, backbone, adapters, batch = _port(arch)
    cfg = cfg.with_(use_pallas=True)
    on = split.split_train_grads(cfg, backbone, adapters, batch)
    off = split.split_train_grads(cfg.with_(remat=False), backbone, adapters, batch)
    assert torch.equal(on[0], off[0]) and on[2] == off[2]
    _bits_equal(on[1], off[1], f"{arch} split remat on vs off")
    fused = _loss_and_grads(cfg, backbone, adapters, batch)
    assert rel_err(on[0], fused[0]) <= TOL
    assert_tree_close(on[1], interop.adapters_to_numpy(fused[1]), TOL, f"{arch} split vs fused")
