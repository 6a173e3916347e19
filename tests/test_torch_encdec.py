"""The port's audio family (whisper-base: encoder-decoder, LayerNorm, learned
positions, GELU MLPs, cross-attention over 1,500 frames at full width)
against the JAX package.

The JAX package draws the weights; they reach the port through
``repro_torch.interop`` as numpy. Activations come from numpy seeds. The
smoke config has 2 encoder and 2 decoder layers, d_model 256, 4 heads of 64,
64 frames of width 128. Where the JAX function reaches Pallas (the
decoder's causal self-attention only) it runs in interpret mode; on the CPU
the port's kernel wrappers take their plain versions. Everything is f32 and
holds to 1e-5 of the reference's ∞-norm (``TOL``); two FedNano rounds'
adapters to ``ADAPTER_TOL`` = 1e-4 (see ``test_torch_training.py``).
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import HyperParams as JHyperParams
from repro.core import adapters as jnano
from repro.core import run_federated as jax_run_federated
from repro.core import server as jserver
from repro.core.comm import CommLog as JCommLog
from repro.core.types import Batch as JBatch
from repro.data import make_federated_data as jax_make_data
from repro.launch import serve as jax_serve
from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving import generate_naive as jax_generate_naive
from repro_torch import interop
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import HyperParams, ServerState, run_federated
from repro_torch.core import adapters as nano
from repro_torch.core import client as client_lib
from repro_torch.core.types import Batch
from repro_torch.data import make_federated_data
from repro_torch.launch import serve, train
from repro_torch.models import attention as attn
from repro_torch.models import encdec, layers
from repro_torch.models import model as model_lib
from repro_torch.models.vision_stub import num_patches
from repro_torch.serving import ServingEngine, generate_naive
from test_torch_training import assert_tree_close, one_torch_thread, rel_err  # noqa: F401

ARCH = "whisper-base"
TOL = 1e-5
ADAPTER_TOL = 1e-4
TENANTS = ["tenant0", "tenant1"]


@functools.lru_cache(maxsize=None)
def _backbone(seed=0):
    """-> (jax cfg, jax params, port cfg, port backbone)."""
    jcfg = jax_smoke_config(ARCH)
    tree = jax.tree.map(np.asarray, jmodel.init_backbone(jax.random.PRNGKey(seed), jcfg))
    cfg = get_smoke_config(ARCH)
    return jcfg, jax.tree.map(jnp.asarray, tree), cfg, interop.backbone_from_numpy(cfg, tree,
                                                                                   "cpu")


def _x(shape, seed, scale=1.0):
    x = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _memory(cfg, B, seed):
    """Connected frame embeddings (B, enc_seq_len, d_model)."""
    return _x((B, cfg.enc_seq_len, cfg.d_model), seed)


def _tokens(cfg, B, S, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return toks, np.tile(np.arange(S, dtype=np.int32), (B, 1))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_layernorm_matches_reference():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 5, 256)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(256).astype(np.float32),
         "bias": rng.standard_normal(256).astype(np.float32)}
    want = jlayers.layernorm(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got = layers.layernorm(interop.adapters_from_numpy(p, "cpu"), torch.from_numpy(x))
    assert rel_err(got, want) <= TOL
    cfg = get_smoke_config(ARCH)
    assert sorted(layers.init_norm(cfg, 8, torch.float32, "cpu")) == ["bias", "scale"]
    assert rel_err(layers.norm(cfg, interop.adapters_from_numpy(p, "cpu"), torch.from_numpy(x)),
                   want) <= TOL


def test_init_tree_matches_reference():
    """The port's own init: the JAX package's leaves and shapes, the learned
    position tables of max_seq_len and enc_seq_len rows."""
    jcfg, jparams, cfg, _ = _backbone()
    mine = model_lib.init_backbone(cfg, seed=0, device="cpu")
    back = interop.backbone_to_numpy(mine, cfg)
    flat_ref = jax.tree_util.tree_flatten_with_path(jparams)[0]
    flat_mine = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_ref) == len(flat_mine)
    for path, leaf in flat_ref:
        assert flat_mine[path].shape == leaf.shape, path
    assert mine["pos"]["pos"].shape == (cfg.max_seq_len, cfg.d_model)
    assert mine["enc_pos"]["pos"].shape == (cfg.enc_seq_len, cfg.d_model)
    assert len(mine["enc_layers"]) == cfg.n_enc_layers and len(mine["dec_layers"]) == cfg.n_layers


@pytest.mark.parametrize("mode", ["bidirectional", "cross"])
def test_full_attention_matches_reference(mode):
    jcfg, jparams, cfg, params = _backbone()
    jp = jax.tree.map(lambda a: a[0], jparams["dec_layers"]["cross_attn"])
    tp = params["dec_layers"][0]["cross_attn"]
    jx, tx = _x((2, 9, cfg.d_model), 2)
    kw, tkw = {}, {}
    if mode == "cross":
        jm, tm = _memory(cfg, 2, 3)
        kw, tkw = dict(memory=jm), dict(memory=tm)
    else:
        kw = tkw = dict(causal=False)
    for use_pallas in (False, True):  # the kernel takes causal self-attention only
        want, (jk, _) = jattn.full_attention(jcfg.with_(use_pallas=use_pallas), jp, jx, None,
                                             return_kv=True, **kw)
        got, (k, _) = attn.full_attention(cfg.with_(use_pallas=use_pallas), tp, tx, None,
                                          return_kv=True, **tkw)
        assert rel_err(got, want) <= TOL and rel_err(k, jk) <= TOL


def test_cross_decode_attention_matches_reference():
    jcfg, jparams, cfg, params = _backbone()
    jp = jax.tree.map(lambda a: a[0], jparams["dec_layers"]["cross_attn"])
    jk, tk = _x((2, cfg.enc_seq_len, cfg.n_kv_heads, cfg.resolved_head_dim), 4)
    jv, tv = _x((2, cfg.enc_seq_len, cfg.n_kv_heads, cfg.resolved_head_dim), 5)
    jx, tx = _x((2, 1, cfg.d_model), 6)
    want = jattn.cross_decode_attention(jcfg, jp, jx, jattn.KVCache(jk, jv))
    got = attn.cross_decode_attention(cfg, params["dec_layers"][0]["cross_attn"], tx,
                                      attn.KVCache(tk, tv))
    assert rel_err(got, want) <= TOL


# ---------------------------------------------------------------------------
# the encoder-decoder
# ---------------------------------------------------------------------------

def test_encode_matches_reference():
    jcfg, jparams, cfg, params = _backbone()
    jm, tm = _memory(cfg, 2, 7)
    assert rel_err(encdec.encode(cfg, params, tm), jencdec.encode(jcfg, jparams, jm)) <= TOL
    assert rel_err(model_lib._encode_memory(cfg, params, tm),
                   jmodel._encode_memory(jcfg, jparams, jm)) <= TOL


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel"])
def test_decode_forward_matches_reference(use_pallas):
    jcfg, jparams, cfg, params = _backbone()
    jcfg, cfg = jcfg.with_(use_pallas=use_pallas), cfg.with_(use_pallas=use_pallas)
    jm, tm = _memory(cfg, 2, 8)
    jx, tx = _x((2, 12, cfg.d_model), 9)
    want, _ = jencdec.decode_forward(jcfg, jparams, jx, jm)
    got, aux = encdec.decode_forward(cfg, params, tx, tm)
    assert float(aux) == 0.0 and rel_err(got, want) <= TOL


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel"])
def test_forward_logits_match_reference(use_pallas):
    jcfg, jparams, cfg, params = _backbone()
    jcfg, cfg = jcfg.with_(use_pallas=use_pallas), cfg.with_(use_pallas=use_pallas)
    toks, pos = _tokens(cfg, 2, 12, seed=10)
    jm, tm = _memory(cfg, 2, 11)
    jh, _ = jmodel.forward(jcfg, jparams, jmodel.embed_tokens(jcfg, jparams, jnp.asarray(toks)),
                           jnp.asarray(pos), jm)
    h, aux = model_lib.forward(cfg, params, model_lib.embed_tokens(
        cfg, params, torch.from_numpy(toks).long()), torch.from_numpy(pos).long(), tm)
    assert float(aux) == 0.0
    assert rel_err(model_lib.logits(cfg, params, h), jmodel.logits(jcfg, jparams, jh)) <= TOL


def test_prefill_then_decode_keeps_the_cross_kv():
    """model.prefill builds the self KV and the cross KV; decode steps write
    the self KV at their positions and leave the cross KV as prefill left it.
    Each step's logits equal the JAX package's decode step, and its state."""
    jcfg, jparams, cfg, params = _backbone()
    S, P = 16, 6
    toks, pos = _tokens(cfg, 2, S, seed=12)
    jm, tm = _memory(cfg, 2, 13)
    jemb = jmodel.embed_tokens(jcfg, jparams, jnp.asarray(toks))
    emb = model_lib.embed_tokens(cfg, params, torch.from_numpy(toks).long())
    jstate, jh = jmodel.prefill(jcfg, jparams, jemb[:, :P], jnp.asarray(pos[:, :P]), capacity=S,
                                enc_embeds=jm)
    state, h = model_lib.prefill(cfg.with_(use_pallas=True), params, emb[:, :P],
                                 torch.from_numpy(pos[:, :P]).long(), capacity=S, enc_embeds=tm)
    assert rel_err(h, jh) <= TOL
    layers_ = state["layers"]
    assert isinstance(layers_, encdec.DecLayerState)
    assert layers_.cross_kv.k.shape == (cfg.n_layers, 2, cfg.enc_seq_len, cfg.n_kv_heads,
                                        cfg.resolved_head_dim)
    assert rel_err(layers_.cross_kv.k, jstate["layers"].cross_kv.k) <= TOL
    assert rel_err(layers_.self_kv.v[:, :, :P], jstate["layers"].self_kv.v[:, :, :P]) <= TOL
    cross = [t.clone() for t in layers_.cross_kv]
    jstep = jax.jit(functools.partial(jmodel.decode_step, jcfg))
    for t in range(P, S):
        got, state = model_lib.decode_step(cfg, params, emb[:, t:t + 1], state, t)
        want, jstate = jstep(jparams, jemb[:, t:t + 1], jstate, jnp.int32(t))
        assert rel_err(got, want) <= TOL, t
    assert all(torch.equal(a, b) for a, b in zip(state["layers"].cross_kv, cross))
    assert rel_err(state["layers"].self_kv.k, jstate["layers"].self_kv.k) <= TOL


def test_decode_step_per_row_positions():
    """One decode over two rows at different positions (the engine's pages)
    equals each row's own decode in the JAX package, learned positions
    read per row."""
    jcfg, jparams, cfg, params = _backbone()
    jm, tm = _memory(cfg, 2, 14)
    toks, pos = _tokens(cfg, 2, 10, seed=15)
    emb = model_lib.embed_tokens(cfg, params, torch.from_numpy(toks).long())
    jemb = jmodel.embed_tokens(jcfg, jparams, jnp.asarray(toks))
    state, _ = model_lib.prefill(cfg, params, emb, torch.from_numpy(pos).long(), 16, enc_embeds=tm)
    rows = torch.tensor([3, 9])
    lg, _ = model_lib.decode_step(cfg, params, emb[:, :1], state, rows)
    for b in range(2):
        jst, _ = jmodel.prefill(jcfg, jparams, jemb[b:b + 1], jnp.asarray(pos[b:b + 1]), 16,
                                enc_embeds=jm[b:b + 1])
        want, _ = jmodel.decode_step(jcfg, jparams, jemb[b:b + 1, :1], jst, jnp.int32(rows[b]))
        assert rel_err(lg[b:b + 1], want) <= TOL, b


# ---------------------------------------------------------------------------
# NanoEdge: the frames through the image adapter
# ---------------------------------------------------------------------------

def _adapters(jcfg):
    rng = np.random.default_rng(5)
    jad = jnano.init_nanoedge(jax.random.PRNGKey(1), jcfg)
    return {m: {"down": np.asarray(a["down"]),
                "up": (rng.standard_normal(a["up"].shape) * 0.05).astype(np.float32)}
            for m, a in jad.items()}


def _batch(cfg, seed, S=12):
    toks, _ = _tokens(cfg, 2, S, seed)
    mask = np.zeros(toks.shape, np.float32)
    mask[:, S // 2:] = 1.0
    frames = np.random.default_rng(seed + 1).standard_normal(
        (2, num_patches(cfg), cfg.frontend_dim)).astype(np.float32)
    labels = np.roll(toks, -1, 1)
    jb = JBatch(tokens=jnp.asarray(toks), labels=jnp.asarray(labels), mask=jnp.asarray(mask),
                patches=jnp.asarray(frames))
    tb = Batch(tokens=torch.from_numpy(toks).long(), labels=torch.from_numpy(labels).long(),
               mask=torch.from_numpy(mask), patches=torch.from_numpy(frames))
    return jb, tb


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel"])
def test_nanoedge_forward_returns_the_adapted_frames(use_pallas):
    jcfg, jparams, cfg, params = _backbone()
    jcfg, cfg = jcfg.with_(use_pallas=use_pallas), cfg.with_(use_pallas=use_pallas)
    ad = _adapters(jcfg)
    jb, tb = _batch(cfg, 16)
    want = jnano.nanoedge_forward(jcfg, jparams, jax.tree.map(jnp.asarray, ad), jb)
    got = nano.nanoedge_forward(cfg, params, interop.adapters_from_numpy(ad, "cpu"), tb)
    assert got[0].shape == (2, 12, cfg.d_model)  # no frame joins the decoder stream
    assert got[4].shape == (2, cfg.enc_seq_len, cfg.d_model)
    for g, w in zip(got, want):
        assert rel_err(g, w) <= TOL


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel"])
def test_loss_and_adapter_grads_match_reference(use_pallas):
    """Both adapters get gradients: text through the decoder's tokens, image
    through the encoder's frames and the cross-attention."""
    jcfg, jparams, cfg, params = _backbone()
    jcfg, cfg = jcfg.with_(use_pallas=use_pallas), cfg.with_(use_pallas=use_pallas)
    ad = _adapters(jcfg)
    jb, tb = _batch(cfg, 17)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda a: jnano.fednano_loss(jcfg, jparams, a, jb), has_aux=True)(
        jax.tree.map(jnp.asarray, ad))
    loss, _, grads = client_lib.value_and_grad(
        lambda a: nano.fednano_loss(cfg, params, a, tb), interop.adapters_from_numpy(ad, "cpu"))
    assert abs(float(loss) - float(jloss)) <= TOL * abs(float(jloss))
    assert float(grads["image"]["up"].abs().max()) > 0
    assert_tree_close(grads, jgrads, TOL, "adapter grads")


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

TRAFFIC = dict(max_slots=3, prefill_len=8, max_new_tokens=6, adapter_slots=4)


def test_engine_tokens_match_jax_engine():
    """Prompts of 2 to 8 tokens padded to 8, each request with its 64
    frames: the frames take no decoder slot, and each page keeps its cross KV."""
    jcfg, jparams, cfg, backbone = _backbone()
    jcfg, cfg = jcfg.with_(use_pallas=True), cfg.with_(use_pallas=True)
    n = 7
    jtenants = jax_serve.synth_tenant_adapters(jax.random.PRNGKey(0), jcfg, TENANTS)
    jeng = JaxServingEngine(jcfg, jparams, adapter_loader=jtenants.__getitem__,
                            use_pallas_grouped=True, **TRAFFIC)
    want = jeng.run(jax_serve.make_requests(jcfg, TENANTS, n, TRAFFIC["prefill_len"],
                                            TRAFFIC["max_new_tokens"], 0))
    tenants = {t: interop.adapters_from_numpy(jax.tree.map(np.asarray, a), "cpu")
               for t, a in jtenants.items()}
    eng = ServingEngine(cfg, backbone, adapter_loader=tenants.__getitem__,
                        use_pallas_grouped=True, **TRAFFIC)
    reqs = serve.make_requests(cfg, TENANTS, n, TRAFFIC["prefill_len"],
                               TRAFFIC["max_new_tokens"], 0)
    assert reqs[0].patches.shape == (cfg.enc_seq_len, cfg.frontend_dim)
    got = eng.run(reqs)
    assert eng.img_prefix == 0 and eng.capacity == TRAFFIC["prefill_len"] + 6 + 1
    assert sorted(got) == sorted(want) == list(range(n))
    for rid in want:
        assert got[rid].tokens == want[rid].tokens, rid


def test_naive_loop_matches_jax_naive_loop():
    """whisper's one-request-at-a-time loop, each request's 64 frames through
    ``enc_embeds``: the JAX loop's tokens, and the port engine's."""
    jcfg, jparams, cfg, backbone = _backbone()
    jcfg, cfg = jcfg.with_(use_pallas=True), cfg.with_(use_pallas=True)
    n = 5
    jtenants = jax_serve.synth_tenant_adapters(jax.random.PRNGKey(0), jcfg, TENANTS)
    want = jax_generate_naive(jcfg, jparams, jax_serve.make_requests(
        jcfg, TENANTS, n, TRAFFIC["prefill_len"], TRAFFIC["max_new_tokens"], 0), jtenants)
    tenants = {t: interop.adapters_from_numpy(jax.tree.map(np.asarray, a), "cpu")
               for t, a in jtenants.items()}
    reqs = serve.make_requests(cfg, TENANTS, n, TRAFFIC["prefill_len"],
                               TRAFFIC["max_new_tokens"], 0)
    got = generate_naive(cfg, backbone, reqs, tenants)
    eng = ServingEngine(cfg, backbone, adapter_loader=tenants.__getitem__,
                        use_pallas_grouped=True, **TRAFFIC).run(reqs)
    for rid in want:
        assert got[rid].tokens == want[rid].tokens == eng[rid].tokens, rid


# ---------------------------------------------------------------------------
# training: two FedNano rounds
# ---------------------------------------------------------------------------

DATA_KW = dict(n_clients=2, examples_per_client=8, batch_size=4, seq_len=16, seed=0)
HP = dict(lr=5e-3, local_steps=2, fisher_batches=2)


@functools.lru_cache(maxsize=None)
def _server():
    jsrv = jserver.init_server(jax.random.PRNGKey(7), jax_smoke_config(ARCH))
    return jsrv, jax.tree.map(np.asarray, jsrv.backbone), jax.tree.map(np.asarray,
                                                                       jsrv.global_adapters)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernels"])
def test_fednano_rounds_match_reference(use_pallas):
    jsrv, backbone, adapters = _server()
    jcfg = jax_smoke_config(ARCH).with_(use_pallas=use_pallas)
    jtrain, jeval, _ = jax_make_data(jcfg, **DATA_KW)
    want = jax_run_federated(jax.random.PRNGKey(0), jcfg, jtrain, jeval, strategy="fednano",
                             rounds=2, hp=JHyperParams(**HP), use_pallas=use_pallas,
                             server=dataclasses.replace(jsrv, comm=JCommLog()))
    cfg = get_smoke_config(ARCH).with_(use_pallas=use_pallas)
    train_b, eval_b, _ = make_federated_data(cfg, device="cpu", **DATA_KW)
    assert train_b[0][0].patches.shape == (4, cfg.enc_seq_len, cfg.frontend_dim)
    srv = ServerState(cfg=cfg, backbone=interop.backbone_from_numpy(cfg, backbone, "cpu"),
                      global_adapters=interop.adapters_from_numpy(adapters, "cpu"))
    got = run_federated(0, cfg, train_b, eval_b, strategy="fednano", rounds=2,
                        hp=HyperParams(**HP), use_pallas=use_pallas, server=srv)
    wl = [m["mean_loss"] for m in want.round_metrics]
    gl = [m["mean_loss"] for m in got.round_metrics]
    for g, w in zip(gl, wl):
        assert abs(g - w) <= TOL * abs(w), (gl, wl)
    assert got.comm_totals == want.comm_totals
    assert got.client_accuracy == want.client_accuracy
    assert_tree_close(got.server.global_adapters, want.server.global_adapters, ADAPTER_TOL,
                      "global adapters")


# ---------------------------------------------------------------------------
# config and the CLIs
# ---------------------------------------------------------------------------

def test_config_is_supported():
    cfg = get_smoke_config(ARCH)
    model_lib.check_supported(cfg)
    assert (cfg.family, cfg.norm, cfg.act, cfg.pos_type) == ("audio", "layernorm", "gelu",
                                                             "learned")
    full = get_config(ARCH)
    assert (full.n_enc_layers, full.n_layers, full.d_model, full.enc_seq_len,
            full.max_seq_len) == (6, 6, 512, 1500, 32768)
    assert num_patches(full) == 1500


def test_serve_and_train_clis_run_on_cpu(tmp_path, capsys):
    rc = serve.main(["--arch", ARCH, "--device", "cpu", "--pallas-grouped", "--requests", "4",
                     "--gen-tokens", "5", "--prefill-len", "8", "--slots", "2"])
    assert rc == 0
    assert f"arch={ARCH} engine: 4 requests, 20 tokens" in capsys.readouterr().out
    rc = train.main(["--arch", ARCH, "--device", "cpu", "--use-pallas", "--clients", "2",
                     "--rounds", "1", "--local-steps", "1", "--examples-per-client", "8",
                     "--batch-size", "4", "--seq-len", "16", "--out", str(tmp_path)])
    assert rc == 0
    summary = json.loads((tmp_path / f"{ARCH}_fednano.json").read_text())
    assert np.isfinite(summary["rounds"][0]["mean_loss"])
