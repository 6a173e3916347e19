"""The port's hybrid family (recurrentgemma-9b: RG-LRU layers and local
attention in (rec, rec, attn) triples, GeGLU) against the JAX package.

The JAX package draws the weights; they reach the port through
``repro_torch.interop`` as numpy. Activations come from numpy seeds. The
smoke config keeps ``reduced()``'s one triple unless a test asks for
``n_layers=5`` (one triple and two extra recurrent layers, so the extras
path runs); its local window is 64 and its conv width 4. Where the JAX
function reaches Pallas it runs in interpret mode; on the CPU the port's
kernel wrappers take their plain versions. Everything is f32 and holds to
1e-5 of the reference's ∞-norm (``TOL``), except where a bound says why:
the decode steps against the JAX package's full forward at 5e-4 (its own
bound in ``tests/test_decode_consistency.py``) and two FedNano rounds'
adapters at ``ADAPTER_TOL`` = 1e-4 (see ``test_torch_training.py``). The
port's scan associates in another order than ``jax.lax.associative_scan``
(Hillis–Steele against the JAX package's odd-even recursion); the tests
hold it at ``TOL`` all the same.
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
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import rglru as jrglru
from repro.serving import Request as JRequest
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
from repro_torch.models import layers
from repro_torch.models import model as model_lib
from repro_torch.models import rglru, transformer
from repro_torch.serving import Request, ServingEngine, generate_naive
from repro_torch.utils import tree_leaves, tree_map, tree_unflatten
from test_torch_training import assert_tree_close, one_torch_thread, rel_err  # noqa: F401

ARCH = "recurrentgemma-9b"
TOL = 1e-5
ADAPTER_TOL = 1e-4
TENANTS = ["tenant0", "tenant1"]


@functools.lru_cache(maxsize=None)
def _backbone(n_layers=3):
    """-> (jax cfg, numpy backbone, port cfg, port backbone). The JAX
    package draws 5 layers (one triple and two extras) once; 3 layers are
    its triple without the extras."""
    jcfg = jax_smoke_config(ARCH, n_layers=n_layers)
    if n_layers == 5:
        tree = jax.tree.map(np.asarray, jmodel.init_backbone(jax.random.PRNGKey(0), jcfg))
    else:
        assert n_layers == 3
        tree = {**_backbone(5)[1], "extras": None}
    cfg = get_smoke_config(ARCH, n_layers=n_layers)
    return jcfg, tree, cfg, interop.backbone_from_numpy(cfg, tree, "cpu")


def _block(n_layers=3):
    """The first triple's rec0 block params: (jax, port)."""
    _, tree, cfg, params = _backbone(n_layers)
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["triples"]["rec0"]["rgl"])
    return jp, params["triples"][0]["rec0"]["rgl"]


def _x(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


# ---------------------------------------------------------------------------
# the RG-LRU block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,length", [(40, None), (40, 40), (40, 1), (40, 17), (70, 64), (1, 1)])
def test_rglru_scan(S, length):
    """h and the cumulative a of the scan; past ``length`` the gates are the
    identity, so h stays at its value at length - 1 (to rounding: the scan
    reaches the two positions by different associations)."""
    jcfg, _, cfg, _ = _backbone()
    jp, tp = _block()
    jx, tx = _x((2, S, cfg.d_model), S)
    jh, (jaa, jhh) = jrglru.rglru_scan(jp, jx, length=None if length is None else jnp.int32(length))
    h, (aa, hh) = rglru.rglru_scan(tp, tx, length=length)
    assert rel_err(h, jh) <= TOL
    assert rel_err(hh, jhh) <= TOL
    assert rel_err(aa, jaa) <= TOL
    if length is not None and length < S:
        assert rel_err(hh[:, -1], hh[:, length - 1]) <= 1e-6


def test_linear_scan_is_the_recurrence():
    """The log-depth scan against the sequential recurrence h_t = a_t h_{t-1} + b_t."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 37, 5)).astype(np.float64))
    b = torch.from_numpy(rng.standard_normal((2, 37, 5)))
    aa, hh = rglru._linear_scan(a, b)
    h, p = torch.zeros(2, 5, dtype=torch.float64), torch.ones(2, 5, dtype=torch.float64)
    for t in range(37):
        h, p = a[:, t] * h + b[:, t], p * a[:, t]
        torch.testing.assert_close(hh[:, t], h, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(aa[:, t], p, rtol=1e-12, atol=1e-12)


def test_causal_conv():
    jp, tp = _block()
    jx, tx = _x((2, 9, 256), 4)
    assert rel_err(rglru._causal_conv(tp, tx), jrglru._causal_conv(jp, jx)) <= TOL


# prompts shorter than conv_width - 1 (= 3), equal to it, and longer; right
# padding masked by ``length``
PREFILL_CASES = [(2, None), (3, None), (40, None), (40, 2), (40, 3), (40, 1), (40, 29)]


@pytest.mark.parametrize("S,length", PREFILL_CASES)
def test_prefill_terminal_state(S, length):
    jcfg, _, cfg, _ = _backbone()
    jp, tp = _block()
    jx, tx = _x((2, S, cfg.d_model), 100 + S)
    jy, jst = jrglru.rglru_block_prefill(jcfg, jp, jx,
                                         length=None if length is None else jnp.int32(length))
    y, st = rglru.rglru_block_prefill(cfg, tp, tx, length=length)
    assert rel_err(y, jy) <= TOL
    assert rel_err(st.conv, jst.conv) <= TOL
    assert rel_err(st.h, jst.h) <= TOL
    assert st.h.dtype == torch.float32 and st.conv.shape == (2, cfg.rglru.conv_width - 1,
                                                             cfg.d_model)
    assert rel_err(rglru.rglru_block(cfg, tp, tx), jrglru.rglru_block(jcfg, jp, jx)) <= TOL
    if length is not None:  # the masked tail leaves the state of the unpadded prompt
        _, short = rglru.rglru_block_prefill(cfg, tp, tx[:, :length])
        assert rel_err(st.conv, short.conv) <= 1e-6
        assert rel_err(st.h, short.h) <= 1e-6


def test_block_step_against_the_scan():
    """Prefill 5 positions, then step the rest one at a time: each step's
    output and state equal the full block's, and the JAX package's step."""
    jcfg, _, cfg, _ = _backbone()
    jp, tp = _block()
    S, P = 12, 5
    jx, tx = _x((2, S, cfg.d_model), 7)
    full = rglru.rglru_block(cfg, tp, tx)
    _, st = rglru.rglru_block_prefill(cfg, tp, tx[:, :P])
    _, jst = jrglru.rglru_block_prefill(jcfg, jp, jx[:, :P])
    for t in range(P, S):
        y, st = rglru.rglru_block_step(cfg, tp, tx[:, t:t + 1], st)
        jy, jst = jrglru.rglru_block_step(jcfg, jp, jx[:, t:t + 1], jst)
        assert rel_err(y, full[:, t:t + 1]) <= TOL
        assert rel_err(y, jy) <= TOL
        assert rel_err(st.h, jst.h) <= TOL and rel_err(st.conv, jst.conv) <= TOL


def test_init_tree_matches_reference():
    """The port's own init: the JAX package's leaves, shapes and dtypes in a
    bf16 backbone (``b_a``, ``b_x``, ``lam`` f32), Λ in its range."""
    jcfg = jax_smoke_config(ARCH, n_layers=5).with_(dtype="bfloat16")
    ref = jax.eval_shape(lambda: jmodel.init_backbone(jax.random.PRNGKey(0), jcfg))
    mine = model_lib.init_backbone(get_smoke_config(ARCH, n_layers=5).with_(dtype="bfloat16"),
                                   seed=0, device="cpu")
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    back = interop.backbone_to_numpy(mine, get_smoke_config(ARCH, n_layers=5))
    flat_mine = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_ref) == len(flat_mine)
    for path, leaf in flat_ref:
        assert flat_mine[path].shape == leaf.shape, path
    rgl = mine["triples"][0]["rec1"]["rgl"]
    for name in ("b_a", "b_x", "lam"):
        assert rgl[name].dtype == torch.float32, name
    assert rgl["w_a"].dtype == torch.bfloat16
    a = torch.exp(-8.0 * torch.nn.functional.softplus(rgl["lam"]))
    assert bool(((a > 0.9 - 1e-4) & (a < 0.999 + 1e-4)).all())


def test_geglu_mlp_matches_reference():
    jcfg, tree, cfg, params = _backbone()
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["triples"]["rec0"]["mlp"])
    assert sorted(jp) == ["w_down", "w_gate", "w_up"]
    jx, tx = _x((2, 6, cfg.d_model), 8)
    got = layers.mlp(cfg, params["triples"][0]["rec0"]["mlp"], tx)
    assert rel_err(got, jlayers.mlp(jcfg, jp, jx)) <= TOL


# ---------------------------------------------------------------------------
# the hybrid stack and the model
# ---------------------------------------------------------------------------

def test_hybrid_split_and_state_layout():
    cfg = get_config(ARCH)
    assert transformer.hybrid_split(cfg) == (12, 2)
    st = model_lib.init_state(get_smoke_config(ARCH, n_layers=5), 3, 100, torch.float32, "cpu")
    tri, ext = st["triples"], st["extras"]
    assert tri["rec0"].conv.shape == (1, 3, 3, 256) and tri["rec1"].h.shape == (1, 3, 256)
    assert tri["attn"].k.shape == (1, 3, 64, 1, 64)  # a ring of the local window
    assert ext.conv.shape == (2, 3, 3, 256) and ext.h.dtype == torch.float32
    assert model_lib.init_state(get_smoke_config(ARCH), 1, 8, torch.float32,
                                "cpu")["extras"] is None


def test_hybrid_split_reads_the_block_pattern():
    """The stack is built of (rec, rec, attn) triples; a config with another
    ``block_pattern`` is refused rather than built as triples."""
    cfg = get_smoke_config(ARCH)
    assert cfg.rglru.block_pattern == ("rec", "rec", "attn")
    other = cfg.with_(rglru=dataclasses.replace(cfg.rglru, block_pattern=("rec", "attn")))
    with pytest.raises(ValueError, match="block_pattern"):
        transformer.hybrid_split(other)
    with pytest.raises(ValueError, match="block_pattern"):
        model_lib.init_backbone(other, seed=0, device="cpu")


def test_tree_helpers_walk_decode_states():
    """``tree_leaves`` and ``tree_map`` walk a decode state's namedtuples
    field by field (dicts by sorted key, as ``jax.tree_util``) and take
    ``None`` (no extra layers) as an empty subtree, so the slot pool's page
    write and a whole-tree cast reach every leaf."""
    st = model_lib.init_state(get_smoke_config(ARCH), 2, 8, torch.float32, "cpu")
    leaves = tree_leaves(st)
    tri = st["triples"]
    assert [t.shape for t in leaves] == [tri["attn"].k.shape, tri["attn"].v.shape,
                                         tri["rec0"].conv.shape, tri["rec0"].h.shape,
                                         tri["rec1"].conv.shape, tri["rec1"].h.shape]
    doubled = tree_map(lambda t: t.double(), st)
    assert doubled["extras"] is None
    assert type(doubled["triples"]["rec0"]) is type(tri["rec0"])
    assert all(t.dtype == torch.float64 for t in tree_leaves(doubled))
    again = tree_unflatten(st, [t + 1 for t in leaves])
    assert type(again["triples"]["attn"]) is type(tri["attn"])
    assert bool((again["triples"]["attn"].v == 1).all())


def _tokens(cfg, B, S, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return toks, np.tile(np.arange(S, dtype=np.int32), (B, 1))


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("n_layers", [3, 5])
def test_forward_logits_match_reference(n_layers, use_pallas):
    """80 positions: the local window of 64 masks keys."""
    jcfg, tree, cfg, params = _backbone(n_layers)
    jcfg, cfg = jcfg.with_(use_pallas=use_pallas), cfg.with_(use_pallas=use_pallas)
    toks, pos = _tokens(cfg, 2, 80, seed=n_layers)
    jparams = jax.tree.map(jnp.asarray, tree)
    jh, _ = jmodel.forward(jcfg, jparams, jmodel.embed_tokens(jcfg, jparams, jnp.asarray(toks)),
                           jnp.asarray(pos))
    h, aux = model_lib.forward(cfg, params, model_lib.embed_tokens(
        cfg, params, torch.from_numpy(toks).long()), torch.from_numpy(pos).long())
    assert float(aux) == 0.0
    assert rel_err(model_lib.logits(cfg, params, h), jmodel.logits(jcfg, jparams, jh)) <= TOL


def _adapters(jcfg):
    rng = np.random.default_rng(5)
    jad = jnano.init_nanoedge(jax.random.PRNGKey(1), jcfg)
    return {m: {"down": np.asarray(a["down"]),
                "up": (rng.standard_normal(a["up"].shape) * 0.05).astype(np.float32)}
            for m, a in jad.items()}


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel"])
def test_loss_and_adapter_grads_match_reference(use_pallas):
    jcfg, tree, cfg, params = _backbone(5)
    jcfg, cfg = jcfg.with_(use_pallas=use_pallas), cfg.with_(use_pallas=use_pallas)
    toks, _ = _tokens(cfg, 2, 24, seed=9)
    mask = np.zeros(toks.shape, np.float32)
    mask[:, 12:] = 1.0
    jb = JBatch(tokens=jnp.asarray(toks), labels=jnp.asarray(np.roll(toks, -1, 1)),
                mask=jnp.asarray(mask))
    tb = Batch(tokens=torch.from_numpy(toks).long(), labels=torch.from_numpy(np.roll(toks, -1, 1))
               .long(), mask=torch.from_numpy(mask))
    ad = _adapters(jcfg)
    jparams = jax.tree.map(jnp.asarray, tree)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda a: jnano.fednano_loss(jcfg, jparams, a, jb), has_aux=True))(
        jax.tree.map(jnp.asarray, ad))
    loss, _, grads = client_lib.value_and_grad(
        lambda a: nano.fednano_loss(cfg, params, a, tb), interop.adapters_from_numpy(ad, "cpu"))
    assert abs(float(loss) - float(jloss)) <= TOL * abs(float(jloss))
    assert_tree_close(grads, jgrads, TOL, "adapter grads")


def test_prefill_then_decode_across_the_window():
    """Prefill 40 positions, decode to 100: the 64-slot ring wraps. Each
    step's logits equal the JAX package's decode step and its full forward
    (5e-4, its own bound); the stacked rec states and ring equal its state."""
    jcfg, tree, cfg, params = _backbone(5)
    S, P = 100, 40
    toks, pos = _tokens(cfg, 2, S, seed=12)
    jparams = jax.tree.map(jnp.asarray, tree)
    jemb = jmodel.embed_tokens(jcfg, jparams, jnp.asarray(toks))
    want = np.asarray(jmodel.logits(jcfg, jparams, jmodel.forward(jcfg, jparams, jemb,
                                                                  jnp.asarray(pos))[0]))
    emb = model_lib.embed_tokens(cfg, params, torch.from_numpy(toks).long())
    state, h = model_lib.prefill(cfg.with_(use_pallas=True), params, emb[:, :P],
                                 torch.from_numpy(pos[:, :P]).long(), capacity=S)
    jstate, jh = jmodel.prefill(jcfg, jparams, jemb[:, :P], jnp.asarray(pos[:, :P]), capacity=S)
    assert rel_err(h, jh) <= TOL
    assert state["triples"]["attn"].k.shape[2] == cfg.rglru.local_window
    jstep = jax.jit(functools.partial(jmodel.decode_step, jcfg))
    for t in range(P, S):
        got, state = model_lib.decode_step(cfg, params, emb[:, t:t + 1], state, t)
        jlg, jstate = jstep(jparams, jemb[:, t:t + 1], jstate, jnp.int32(t))
        assert rel_err(got, jlg) <= TOL, t
        assert float(np.max(np.abs(got[:, 0].numpy() - want[:, t]))) < 5e-4, t
    for name in ("rec0", "rec1"):
        assert rel_err(state["triples"][name].h, jstate["triples"][name].h) <= TOL
        assert rel_err(state["triples"][name].conv, jstate["triples"][name].conv) <= TOL
    assert rel_err(state["triples"]["attn"].k, jstate["triples"]["attn"].k) <= TOL
    assert rel_err(state["extras"].h, jstate["extras"].h) <= TOL


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

# prompts of 1 to 12 tokens padded to 12, several shorter than the conv
# window (cw - 1 = 3), with 58 new tokens: decode wraps the 64-slot ring
PROMPTS = [(TENANTS[0], 1), (TENANTS[1], 2), (None, 3), (TENANTS[0], 12), (TENANTS[1], 7),
           (None, 5)]
TRAFFIC = dict(max_slots=3, prefill_len=12, max_new_tokens=58, adapter_slots=4)


def _requests(cls, vocab):
    rng = np.random.default_rng(4)
    return [cls(rid=i, tenant=t, prompt=rng.integers(0, vocab, n).astype(np.int32),
                max_new_tokens=TRAFFIC["max_new_tokens"]) for i, (t, n) in enumerate(PROMPTS)]


def test_engine_tokens_match_jax_engine():
    jcfg, tree, cfg, backbone = _backbone(5)
    jcfg, cfg = jcfg.with_(use_pallas=True), cfg.with_(use_pallas=True)
    jtenants = jax_serve.synth_tenant_adapters(jax.random.PRNGKey(0), jcfg, TENANTS)
    jeng = JaxServingEngine(jcfg, jax.tree.map(jnp.asarray, tree),
                            adapter_loader=jtenants.__getitem__, use_pallas_grouped=True,
                            **TRAFFIC)
    want = jeng.run(_requests(JRequest, cfg.vocab_size))
    tenants = {t: interop.adapters_from_numpy(jax.tree.map(np.asarray, a), "cpu")
               for t, a in jtenants.items()}
    eng = ServingEngine(cfg, backbone, adapter_loader=tenants.__getitem__,
                        use_pallas_grouped=True, **TRAFFIC)
    got = eng.run(_requests(Request, cfg.vocab_size))
    assert sorted(got) == sorted(want) == list(range(len(PROMPTS)))
    for rid in want:
        assert got[rid].tokens == want[rid].tokens, rid
    assert eng.slots.state["triples"]["attn"].k.shape[2] == 64 < eng.capacity


def test_naive_loop_matches_jax_naive_loop():
    """recurrentgemma at 5 layers, prompts of 1 to 12 tokens (unpadded, some
    shorter than the conv window) decoding past the 64-slot ring: the JAX
    loop's tokens, and the port engine's."""
    jcfg, tree, cfg, backbone = _backbone(5)
    jcfg, cfg = jcfg.with_(use_pallas=True), cfg.with_(use_pallas=True)
    jtenants = jax_serve.synth_tenant_adapters(jax.random.PRNGKey(0), jcfg, TENANTS)
    want = jax_generate_naive(jcfg, jax.tree.map(jnp.asarray, tree),
                              _requests(JRequest, cfg.vocab_size), jtenants)
    tenants = {t: interop.adapters_from_numpy(jax.tree.map(np.asarray, a), "cpu")
               for t, a in jtenants.items()}
    reqs = _requests(Request, cfg.vocab_size)
    got = generate_naive(cfg, backbone, reqs, tenants)
    eng = ServingEngine(cfg, backbone, adapter_loader=tenants.__getitem__,
                        use_pallas_grouped=True, **TRAFFIC).run(reqs)
    for rid in want:
        assert got[rid].tokens == want[rid].tokens == eng[rid].tokens, rid


def test_window_guard_reads_the_local_window():
    """The hybrid config has no ``sliding_window``; its ring is the local
    window, and a padded prefill longer than it is refused."""
    _, _, cfg, backbone = _backbone()
    assert cfg.sliding_window is None
    with pytest.raises(ValueError, match="window"):
        ServingEngine(cfg, backbone, max_slots=1, prefill_len=65, max_new_tokens=4)
    ServingEngine(cfg, backbone, max_slots=1, prefill_len=64, max_new_tokens=4)


# ---------------------------------------------------------------------------
# training: two FedNano rounds
# ---------------------------------------------------------------------------

DATA_KW = dict(n_clients=2, examples_per_client=8, batch_size=4, seq_len=24, seed=0)
HP = dict(lr=5e-3, local_steps=2, fisher_batches=2)


@functools.lru_cache(maxsize=None)
def _server():
    jsrv = jserver.init_server(jax.random.PRNGKey(7), jax_smoke_config(ARCH, n_layers=5))
    return jsrv, jax.tree.map(np.asarray, jsrv.backbone), jax.tree.map(np.asarray,
                                                                       jsrv.global_adapters)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernels"])
def test_fednano_rounds_match_reference(use_pallas):
    jsrv, backbone, adapters = _server()
    jcfg = jax_smoke_config(ARCH, n_layers=5).with_(use_pallas=use_pallas)
    jtrain, jeval, _ = jax_make_data(jcfg, **DATA_KW)
    want = jax_run_federated(jax.random.PRNGKey(0), jcfg, jtrain, jeval, strategy="fednano",
                             rounds=2, hp=JHyperParams(**HP), use_pallas=use_pallas,
                             server=dataclasses.replace(jsrv, comm=JCommLog()))
    cfg = get_smoke_config(ARCH, n_layers=5).with_(use_pallas=use_pallas)
    train_b, eval_b, _ = make_federated_data(cfg, device="cpu", **DATA_KW)
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
    assert (cfg.family, cfg.act, cfg.n_layers, cfg.rglru.local_window) == ("hybrid", "geglu", 3,
                                                                          64)
    full = get_config(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads, full.head_dim) == (
        38, 4096, 16, 1, 256)


def test_serve_and_train_clis_run_on_cpu(tmp_path, capsys):
    rc = serve.main(["--arch", ARCH, "--device", "cpu", "--pallas-grouped", "--requests", "4",
                     "--gen-tokens", "30", "--prefill-len", "40", "--slots", "2"])
    assert rc == 0
    assert f"arch={ARCH} engine: 4 requests, 120 tokens" in capsys.readouterr().out
    rc = train.main(["--arch", ARCH, "--device", "cpu", "--use-pallas", "--clients", "2",
                     "--rounds", "1", "--local-steps", "1", "--examples-per-client", "8",
                     "--batch-size", "4", "--seq-len", "80", "--out", str(tmp_path)])
    assert rc == 0
    summary = json.loads((tmp_path / f"{ARCH}_fednano.json").read_text())
    assert np.isfinite(summary["rounds"][0]["mean_loss"])
