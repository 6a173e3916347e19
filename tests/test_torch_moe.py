"""The port's MoE family (llama4-scout-17b-a16e: top-1 with a shared expert;
grok-1-314b: top-2 with GELU experts and attention logits capped at 30)
against the JAX package.

Weights are the JAX package's, exported through ``repro_torch.interop`` as
numpy; activations come from numpy seeds. Where the JAX function reaches
Pallas it runs in interpret mode, as the JAX package's own tests run it; on
the CPU the port's kernel wrappers take their plain versions. Everything is
f32. The MoE layer, attention and forward logits hold to 1e-5 of the
reference's ∞-norm, and the expert slots each token's choices take (so the
dropped choices too) are held exactly; prefill + decode to 5e-4 (the JAX
package's own bound in ``tests/test_decode_consistency.py``, with capacity
factor 8 there as here); two FedNano rounds' adapters to ``ADAPTER_TOL`` =
1e-4 (see ``test_torch_training.py``).

The JAX layer's routing is read through its sharding hint: ``moe_apply``
passes the grouped tokens and then the dispatched expert inputs through
``repro.models.moe.constrain``, which the tests replace by a function that
keeps its argument.
"""
import dataclasses
import functools
import importlib.util
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import HyperParams as JHyperParams
from repro.core import run_federated as jax_run_federated
from repro.core import server as jserver
from repro.core.comm import CommLog as JCommLog
from repro.data import make_federated_data as jax_make_data
from repro.launch import serve as jax_serve
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.models import rotary as jrotary
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving import generate_naive as jax_generate_naive
from repro_torch import interop
from repro_torch.configs import get_smoke_config
from repro_torch.core import HyperParams, ServerState, run_federated
from repro_torch.data import make_federated_data
from repro_torch.launch import serve, train
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import model as model_lib
from repro_torch.models import moe
from repro_torch.models import rotary
from repro_torch.serving import ServingEngine, generate_naive
from test_torch_training import assert_tree_close, one_torch_thread, rel_err  # noqa: F401

LLAMA4, GROK = "llama4-scout-17b-a16e", "grok-1-314b"
MOE = [LLAMA4, GROK]
TOL = 1e-5
ADAPTER_TOL = 1e-4
TENANTS = ["tenant0", "tenant1"]


def _with_cf(cfg, cf):
    return cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


@functools.lru_cache(maxsize=None)
def _backbone(arch, seed=0):
    """-> (jax cfg, numpy backbone, port cfg, port backbone)."""
    jcfg = jax_smoke_config(arch)
    tree = jax.tree.map(np.asarray, jmodel.init_backbone(jax.random.PRNGKey(seed), jcfg))
    cfg = get_smoke_config(arch)
    return jcfg, tree, cfg, interop.backbone_from_numpy(cfg, tree, "cpu")


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

def _tokens(d, B, S, seed):
    """Tokens about one shared centre, so the router favours some experts
    over others and their capacity drops choices."""
    rng = np.random.default_rng(seed)
    centre = rng.standard_normal(d)
    return (rng.standard_normal((B, S, d)) * 0.5 + centre).astype(np.float32)


def _jax_moe(jcfg, jp, x, monkeypatch):
    """-> (y, balance loss, {(group, token, expert): slot} of the kept choices)."""
    seen = []

    def keep_arg(a, spec):
        seen.append(np.asarray(a))
        return a

    monkeypatch.setattr(jmoe, "constrain", keep_arg)
    y, aux = jmoe.moe_apply(jcfg, jp, jnp.asarray(x))
    xg, xe = seen[0], seen[1]  # (g, G, D) grouped tokens, (E, g, C, D) expert inputs
    slots = {}
    for e in range(xe.shape[0]):
        for g in range(xe.shape[1]):
            same = (xe[e, g][:, None, :] == xg[g][None, :, :]).all(-1)  # (C, G)
            for c in np.flatnonzero(xe[e, g].any(-1)):
                t = np.flatnonzero(same[c])
                assert len(t) == 1, (e, g, c)
                slots[(g, int(t[0]), e)] = int(c)
    return np.asarray(y), float(aux["lb_loss"]), slots


def _recorded_routes(monkeypatch):
    """-> the list that receives each ``moe.route`` result from now on."""
    routes, route = [], moe.route
    monkeypatch.setattr(moe, "route", lambda *a: routes.append(route(*a)) or routes[-1])
    return routes


def _port_moe(cfg, p, x, monkeypatch):
    routes = _recorded_routes(monkeypatch)
    y, lb = moe.moe_apply(cfg, p, torch.from_numpy(x))
    r = routes[0]
    idx, keep, slot = r.idx.numpy(), r.keep.numpy(), r.slot.numpy()
    slots = {(g, t, int(idx[g, t, k])): int(slot[g, t, k])
             for g, t, k in zip(*np.nonzero(keep))}
    return y, float(lb), slots, r


MOE_CASES = [
    # (id, B, S, capacity factor or None for the config's 1.25)
    ("24-cf1.25", 2, 12, None),       # drops
    ("600", 1, 600, None),            # 512 does not divide 600: groups of 300
    ("521-prime", 1, 521, None),      # prime above 512: groups of 1
    ("cf-above-int", 1, 16, "above"),  # G·K·cf/E 0.0005 above an integer
]


@pytest.mark.parametrize("case", MOE_CASES, ids=[c[0] for c in MOE_CASES])
@pytest.mark.parametrize("arch", MOE)
def test_moe_apply_matches_reference(arch, case, monkeypatch):
    _, B, S, cf = case
    jcfg, tree, cfg, params = _backbone(arch)
    mcfg = cfg.moe
    G = moe._group_size(B * S)
    if cf == "above":
        base = G * mcfg.top_k / mcfg.n_experts
        cf = (base + 5e-4) / base
        # int(q + 0.999) keeps the integer where ceil would move to the next slot block
        assert moe.capacity(_with_cf(cfg, cf), G) < min(
            moe._round_up(math.ceil(G * mcfg.top_k * cf / mcfg.n_experts), 4), G * mcfg.top_k)
    if cf is not None:
        jcfg, cfg = _with_cf(jcfg, cf), _with_cf(cfg, cf)
    x = _tokens(cfg.d_model, B, S, seed=B * S)
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["layers"]["moe"])
    want_y, want_lb, want_slots = _jax_moe(jcfg, jp, x, monkeypatch)
    got_y, got_lb, got_slots, rec = _port_moe(cfg, params["layers"][0]["moe"], x, monkeypatch)

    assert rec.idx.shape == (B * S // G, G, mcfg.top_k)
    assert got_slots == want_slots
    n_dropped = B * S * mcfg.top_k - len(got_slots)
    if case[0] in ("24-cf1.25", "cf-above-int"):
        assert 0 < n_dropped < B * S * mcfg.top_k
    if G == 1:
        assert n_dropped == 0 and rec.capacity == mcfg.top_k
    assert rel_err(got_y, want_y) <= TOL
    assert abs(got_lb - want_lb) <= TOL * abs(want_lb)


@pytest.mark.parametrize("tokens", [1, 24, 511, 512, 513, 521, 600, 1024, 1031, 4103, 6144])
def test_group_size_matches_reference(tokens):
    assert moe._group_size(tokens) == jmoe._group_size(tokens)


def test_decode_routes_each_row_alone():
    """``group=1``: row b's output is the layer applied to row b alone, as the
    JAX engine's vmap over pages gives it; here capacity would drop choices
    if the rows routed together."""
    _, _, cfg, params = _backbone(LLAMA4)
    p = params["layers"][0]["moe"]
    x = _tokens(cfg.d_model, 16, 1, seed=3)
    together = moe.moe_apply(cfg, p, torch.from_numpy(x))[0]
    alone = moe.moe_apply(cfg, p, torch.from_numpy(x), group=1)[0]
    rows = torch.cat([moe.moe_apply(cfg, p, torch.from_numpy(x[b:b + 1]))[0] for b in range(16)])
    assert float((alone - rows).abs().max()) <= 1e-6 * float(rows.abs().max())
    assert float((together - rows).abs().max()) > 1e-3  # the batch's capacity dropped some


@pytest.mark.parametrize("arch", MOE)
def test_batched_decode_step_matches_reference_decode_step(arch, monkeypatch):
    """``model.decode_step`` on 16 rows routes them as one group of 16, as
    JAX's ``model.decode_step`` does, and the group's capacity drops choices
    (asserted); with ``moe_group=1`` each row routes alone, drops none, and
    equals JAX's decode of that row alone (the JAX engine's vmap)."""
    jcfg, tree, cfg, params = _backbone(arch)
    B, P = 16, 4
    jparams, jemb, emb = _embeds(jcfg, tree, cfg, params, B, P, seed=1)
    pos = np.tile(np.arange(P), (B, 1))
    x = _tokens(cfg.d_model, B, 1, seed=1)
    jstate, _ = jmodel.prefill(jcfg, jparams, jemb, jnp.asarray(pos), capacity=8)
    want, _ = jmodel.decode_step(jcfg, jparams, jnp.asarray(x), jstate, jnp.int32(P))

    def decode(moe_group):
        state, _ = model_lib.prefill(cfg, params, emb, torch.from_numpy(pos), capacity=8)
        routes = _recorded_routes(monkeypatch)
        lg, _ = model_lib.decode_step(cfg, params, torch.from_numpy(x), state, P,
                                      moe_group=moe_group)
        monkeypatch.undo()
        return lg, routes

    got, routes = decode(None)
    assert [r.idx.shape[:2] for r in routes] == [(1, B)] * cfg.n_layers
    assert sum(int((~r.keep).sum()) for r in routes) > 0  # the batch's capacity dropped some
    assert rel_err(got, want) <= TOL
    alone, routes = decode(1)
    assert all(r.idx.shape[:2] == (B, 1) and bool(r.keep.all()) for r in routes)
    for b in (0, 7, 15):
        jst = jax.tree.map(lambda a: a[:, b:b + 1], jstate)
        row, _ = jmodel.decode_step(jcfg, jparams, jnp.asarray(x[b:b + 1]), jst, jnp.int32(P))
        assert rel_err(alone[b:b + 1], row) <= TOL, b
    assert rel_err(alone, got) > 1e-3


def _chip_smoke():
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", MOE)
def test_chip_smoke_replays_expert_choices(arch, monkeypatch):
    """``chip_smoke.py`` holds a run on the plain versions against a kernel
    run with the kernel run's expert choices replayed: on the same input
    the replay changes no bit; on another input each call takes the
    recorded choices, slots and drops, with gates from its own router
    probabilities at those choices; a call the record lacks, or a record
    left over, fails."""
    cs = _chip_smoke()
    _, _, cfg, params = _backbone(arch)
    p = params["layers"][0]["moe"]
    x = torch.from_numpy(_tokens(cfg.d_model, 2, 12, seed=5))
    with cs.recorded_routes() as rec:
        y, lb = moe.moe_apply(cfg, p, x)
    with cs.replayed_routes(rec) as own:
        y_same, lb_same = moe.moe_apply(cfg, p, x)
    assert torch.equal(y_same, y) and torch.equal(lb_same, lb)
    assert torch.equal(own[0].idx, rec[0].idx)

    x2 = torch.from_numpy(_tokens(cfg.d_model, 2, 12, seed=6))
    with cs.replayed_routes(rec) as own2:
        y2, _ = moe.moe_apply(cfg, p, x2)
    assert not torch.equal(own2[0].idx, rec[0].idx)  # x2 would choose other experts
    r = own2[0]
    gates = r.probs.gather(-1, rec[0].idx)
    forced = r._replace(gates=gates / gates.sum(-1, keepdim=True), idx=rec[0].idx,
                        keep=rec[0].keep, slot=rec[0].slot)
    monkeypatch.setattr(moe, "route", lambda *a: forced)
    assert torch.equal(y2, moe.moe_apply(cfg, p, x2)[0])
    monkeypatch.undo()

    with pytest.raises(AssertionError, match="replay"):
        with cs.replayed_routes([]):
            moe.moe_apply(cfg, p, x)
    with pytest.raises(AssertionError, match="replay"):
        with cs.replayed_routes(rec + rec):
            moe.moe_apply(cfg, p, x)


def test_init_moe_tree():
    """The JAX tree: an f32 router in a bf16 backbone, experts (E, d, f), the
    unused ``w_gate`` kept under GELU, a shared expert only with shared_d_ff."""
    for arch in MOE:
        cfg = get_smoke_config(arch)
        p = moe.init_moe(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
        jp = jmoe.init_moe(jax.random.PRNGKey(0), cfg, dtype=jnp.bfloat16)
        assert sorted(p) == sorted(jp)
        for name, leaf in jp.items():
            if name == "shared":
                assert {k: tuple(v.shape) for k, v in p[name].items()} == \
                    {k: tuple(v.shape) for k, v in leaf.items()}
                continue
            assert tuple(p[name].shape) == tuple(leaf.shape), name
            assert str(p[name].dtype).split(".")[-1] == str(leaf.dtype), name
    assert p["router"].dtype == torch.float32 and "w_gate" in p and "shared" not in p


def test_interop_carries_the_moe_tree():
    _, tree, cfg, params = _backbone(LLAMA4)
    lp = params["layers"][1]["moe"]
    assert lp["router"].dtype == torch.float32
    np.testing.assert_array_equal(lp["w_gate"].numpy(), tree["layers"]["moe"]["w_gate"][1])
    np.testing.assert_array_equal(lp["shared"]["w_down"].numpy(),
                                  tree["layers"]["moe"]["shared"]["w_down"][1])
    back = interop.backbone_to_numpy(params, cfg)
    jax.tree.map(np.testing.assert_array_equal, back["layers"]["moe"], tree["layers"]["moe"])


# ---------------------------------------------------------------------------
# GELU
# ---------------------------------------------------------------------------

def test_gelu_mlp_matches_reference():
    jcfg = jax_smoke_config(GROK)
    cfg = get_smoke_config(GROK)
    jp = jax.tree.map(np.asarray, jlayers.init_mlp(jax.random.PRNGKey(4), jcfg, d_ff=96))
    assert sorted(jp) == ["w_down", "w_up"]
    gen = torch.Generator().manual_seed(0)
    assert {k: tuple(v.shape) for k, v in layers.init_mlp(gen, cfg, torch.float32, d_ff=96)
            .items()} == {k: v.shape for k, v in jp.items()}
    x = np.random.default_rng(5).standard_normal((2, 7, cfg.d_model)).astype(np.float32) * 3
    want = jlayers.mlp(jcfg, jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    got = layers.mlp(cfg, {k: torch.from_numpy(v.copy()) for k, v in jp.items()},
                     torch.from_numpy(x))
    assert rel_err(got, want) <= TOL
    # jax.nn.gelu is the tanh form; the erf form is another function
    h = torch.from_numpy(x).double()
    assert float((layers.gelu(h) - F.gelu(h)).abs().max()) > 1e-4


# ---------------------------------------------------------------------------
# the attention softcap (grok-1: 30)
# ---------------------------------------------------------------------------

def test_sdpa_softcap_matches_reference():
    jcfg, _, cfg, _ = _backbone(GROK)
    assert cfg.logit_softcap == 30.0
    rng = np.random.default_rng(30)
    B, S, hd = 2, 10, cfg.resolved_head_dim
    # logits well past the cap (std about 36)
    q = (rng.standard_normal((B, S, cfg.n_heads, hd)) * 6).astype(np.float32)
    k, v = ((rng.standard_normal((B, S, cfg.n_kv_heads, hd)) * 6).astype(np.float32)
            for _ in range(2))
    mask = np.tril(np.ones((S, S), bool))
    want = jattn.sdpa(jcfg, *(jnp.asarray(a) for a in (q, k, v, mask)))
    got = attn.sdpa(cfg, *(torch.from_numpy(a) for a in (q, k, v, mask)))
    assert rel_err(got, want) <= TOL
    uncapped = attn.sdpa(cfg.with_(logit_softcap=0.0), *(torch.from_numpy(a)
                                                         for a in (q, k, v, mask)))
    assert float((got - uncapped).abs().max()) > 1e-2


def test_decode_attention_softcap_matches_reference():
    jcfg, tree, cfg, params = _backbone(GROK)
    rng = np.random.default_rng(31)
    B, C, pos, hd = 2, 10, 7, cfg.resolved_head_dim
    x = (rng.standard_normal((B, 1, cfg.d_model)) * 20).astype(np.float32)
    ck, cv = ((rng.standard_normal((B, C, cfg.n_kv_heads, hd)) * 20).astype(np.float32)
              for _ in range(2))
    ang = jrotary.rope_angles(jnp.full((B, 1), pos), hd, cfg.rope_theta)
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["layers"]["attn"])
    want, wcache = jattn.decode_attention(jcfg, jp, jnp.asarray(x), ang,
                                          jattn.KVCache(jnp.asarray(ck), jnp.asarray(cv)),
                                          jnp.int32(pos))
    cache = attn.KVCache(torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()))
    tang = rotary.rope_angles(torch.full((B, 1), pos), hd, cfg.rope_theta)
    lp = params["layers"][0]["attn"]
    got, cache = attn.decode_attention(cfg, lp, torch.from_numpy(x), tang, cache,
                                       torch.full((B,), pos))
    assert rel_err(got, want) <= TOL
    assert rel_err(cache.k, wcache.k) <= TOL
    cache = attn.KVCache(torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()))
    uncapped, _ = attn.decode_attention(cfg.with_(logit_softcap=0.0), lp, torch.from_numpy(x),
                                        tang, cache, torch.full((B,), pos))
    assert float((got - uncapped).abs().max()) > 1e-2 * float(got.abs().max())


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("arch", MOE)
def test_full_attention_matches_reference(arch, use_pallas):
    """Training and prefill attention: grok's softcap through the flash
    wrapper (interpret-mode Pallas on the JAX side) and through sdpa."""
    jcfg, tree, cfg, params = _backbone(arch)
    jcfg, cfg = jcfg.with_(use_pallas=use_pallas), cfg.with_(use_pallas=use_pallas)
    rng = np.random.default_rng(32)
    # grok: inputs that take its logits past the cap
    x = (rng.standard_normal((2, 24, cfg.d_model)) * (12 if cfg.logit_softcap else 1)
         ).astype(np.float32)
    pos = np.tile(np.arange(24, dtype=np.int32), (2, 1))
    hd, theta = cfg.resolved_head_dim, cfg.rope_theta
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["layers"]["attn"])
    want = jattn.full_attention(jcfg, jp, jnp.asarray(x),
                                jrotary.rope_angles(jnp.asarray(pos), hd, theta))
    ang = rotary.rope_angles(torch.from_numpy(pos).long(), hd, theta)
    got = attn.full_attention(cfg, params["layers"][0]["attn"], torch.from_numpy(x), ang)
    assert rel_err(got, want) <= TOL
    if cfg.logit_softcap:
        uncapped = attn.full_attention(cfg.with_(logit_softcap=0.0), params["layers"][0]["attn"],
                                       torch.from_numpy(x), ang)
        assert float((got - uncapped).abs().max()) > 1e-3 * float(got.abs().max())


# ---------------------------------------------------------------------------
# the model: forward logits, prefill + decode
# ---------------------------------------------------------------------------

def _embeds(jcfg, tree, cfg, params, B, S, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jparams = jax.tree.map(jnp.asarray, tree)
    return (jparams, jmodel.embed_tokens(jcfg, jparams, jnp.asarray(toks)),
            model_lib.embed_tokens(cfg, params, torch.from_numpy(toks).long()))


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("arch", MOE)
def test_forward_logits_and_aux_match_reference(arch, use_pallas, monkeypatch):
    """At the config's capacity factor: 24 tokens route as one group and the
    capacity drops choices in each layer, on both sides alike."""
    jcfg, tree, cfg, params = _backbone(arch)
    jcfg, cfg = jcfg.with_(use_pallas=use_pallas), cfg.with_(use_pallas=use_pallas)
    B, S = 2, 12
    jparams, jemb, emb = _embeds(jcfg, tree, cfg, params, B, S, seed=12)
    pos = np.tile(np.arange(S), (B, 1))
    jh, jaux = jmodel.forward(jcfg, jparams, jemb, jnp.asarray(pos))
    routes = _recorded_routes(monkeypatch)
    h, aux = model_lib.forward(cfg, params, emb, torch.from_numpy(pos))
    dropped = [int((~r.keep).sum()) for r in routes]
    assert len(dropped) == cfg.n_layers and sum(dropped) > 0
    assert rel_err(model_lib.logits(cfg, params, h), jmodel.logits(jcfg, jparams, jh)) <= TOL
    assert abs(float(aux) - float(jaux)) <= TOL * abs(float(jaux))


@pytest.mark.parametrize("arch", MOE)
def test_prefill_decode_matches_reference_decode(arch):
    """Capacity factor 8 (no drops), as the JAX package's own test: prefill
    half the sequence, then decode the rest one token at a time."""
    jcfg, tree, cfg, params = _backbone(arch)
    jcfg, cfg = _with_cf(jcfg, 8.0), _with_cf(cfg, 8.0)
    B, S = 2, 12
    jparams, jemb, emb = _embeds(jcfg, tree, cfg, params, B, S, seed=13)
    pos = np.tile(np.arange(S), (B, 1))
    half = S // 2
    jstate, _ = jmodel.prefill(jcfg, jparams, jemb[:, :half], jnp.asarray(pos[:, :half]),
                               capacity=S)
    state, _ = model_lib.prefill(cfg, params, emb[:, :half], torch.from_numpy(pos[:, :half]),
                                 capacity=S)
    for t in range(half, S):
        want, jstate = jmodel.decode_step(jcfg, jparams, jemb[:, t:t + 1], jstate, jnp.int32(t))
        got, state = model_lib.decode_step(cfg, params, emb[:, t:t + 1], state, t)
        err = float(np.max(np.abs(got.numpy() - np.asarray(want))))
        assert err < 5e-4, f"{arch}: step {t} logits diverge by {err}"
        assert rel_err(got, want) <= TOL


# ---------------------------------------------------------------------------
# serving: the engine's tokens against the JAX engine's
# ---------------------------------------------------------------------------

# prompts of 2 to 8 tokens padded to 8: the pads route and take capacity in
# prefill; decode routes each of the 8 pages alone (routed together, llama4's
# pages would lose choices to capacity and its tokens would differ)
TRAFFIC = dict(max_slots=8, prefill_len=8, max_new_tokens=6, adapter_slots=4)


@pytest.mark.parametrize("arch", MOE)
def test_engine_tokens_match_jax_engine(arch):
    jcfg, tree, cfg, backbone = _backbone(arch)
    jcfg, cfg = jcfg.with_(use_pallas=True), cfg.with_(use_pallas=True)
    kw, n = TRAFFIC, 10
    jtenants = jax_serve.synth_tenant_adapters(jax.random.PRNGKey(0), jcfg, TENANTS)
    jeng = JaxServingEngine(jcfg, jax.tree.map(jnp.asarray, tree),
                            adapter_loader=jtenants.__getitem__, use_pallas_grouped=True, **kw)
    want = jeng.run(jax_serve.make_requests(jcfg, TENANTS, n, kw["prefill_len"],
                                            kw["max_new_tokens"], 0))
    tenants = {t: interop.adapters_from_numpy(jax.tree.map(np.asarray, a), "cpu")
               for t, a in jtenants.items()}
    eng = ServingEngine(cfg, backbone, adapter_loader=tenants.__getitem__,
                        use_pallas_grouped=True, **kw)
    got = eng.run(serve.make_requests(cfg, TENANTS, n, kw["prefill_len"],
                                      kw["max_new_tokens"], 0))
    assert sorted(got) == sorted(want) == list(range(n))
    for rid in want:
        assert got[rid].tokens == want[rid].tokens, rid


def test_naive_loop_matches_jax_naive_loop():
    """llama4's one-request-at-a-time loop (one row routes as one group,
    capacity drops in prefill): the JAX loop's tokens, and the port
    engine's."""
    jcfg, tree, cfg, backbone = _backbone(LLAMA4)
    jcfg, cfg = jcfg.with_(use_pallas=True), cfg.with_(use_pallas=True)
    kw, n = TRAFFIC, 6
    jtenants = jax_serve.synth_tenant_adapters(jax.random.PRNGKey(0), jcfg, TENANTS)
    want = jax_generate_naive(jcfg, jax.tree.map(jnp.asarray, tree),
                              jax_serve.make_requests(jcfg, TENANTS, n, kw["prefill_len"],
                                                      kw["max_new_tokens"], 0), jtenants)
    tenants = {t: interop.adapters_from_numpy(jax.tree.map(np.asarray, a), "cpu")
               for t, a in jtenants.items()}
    reqs = serve.make_requests(cfg, TENANTS, n, kw["prefill_len"], kw["max_new_tokens"], 0)
    got = generate_naive(cfg, backbone, reqs, tenants)
    eng = ServingEngine(cfg, backbone, adapter_loader=tenants.__getitem__,
                        use_pallas_grouped=True, **kw).run(reqs)
    for rid in want:
        assert got[rid].tokens == want[rid].tokens == eng[rid].tokens, rid


# ---------------------------------------------------------------------------
# training: two FedNano rounds
# ---------------------------------------------------------------------------

DATA_KW = dict(n_clients=2, examples_per_client=16, batch_size=4, seq_len=16, seed=0)
HP = dict(lr=5e-3, local_steps=2, fisher_batches=2)


@functools.lru_cache(maxsize=None)
def _server(arch):
    jsrv = jserver.init_server(jax.random.PRNGKey(7), jax_smoke_config(arch))
    return jsrv, jax.tree.map(np.asarray, jsrv.backbone), jax.tree.map(np.asarray,
                                                                       jsrv.global_adapters)


def _port_server(cfg):
    _, backbone, adapters = _server(cfg.name)
    return ServerState(cfg=cfg, backbone=interop.backbone_from_numpy(cfg, backbone, "cpu"),
                       global_adapters=interop.adapters_from_numpy(adapters, "cpu"))


ROUND_CASES = [(LLAMA4, True), (GROK, True), (GROK, False)]


@pytest.mark.parametrize("arch,use_pallas", ROUND_CASES,
                         ids=[f"{a.split('-')[0]}-{'kernels' if p else 'plain'}"
                              for a, p in ROUND_CASES])
def test_fednano_rounds_match_reference(arch, use_pallas):
    """Batches of 4 x 16 tokens route as one group of 64 at cf 1.25."""
    jcfg = jax_smoke_config(arch).with_(use_pallas=use_pallas)
    jtrain, jeval, _ = jax_make_data(jcfg, **DATA_KW)
    want = jax_run_federated(jax.random.PRNGKey(0), jcfg, jtrain, jeval, strategy="fednano",
                             rounds=2, hp=JHyperParams(**HP), use_pallas=use_pallas,
                             server=dataclasses.replace(_server(arch)[0], comm=JCommLog()))
    cfg = get_smoke_config(arch).with_(use_pallas=use_pallas)
    train_b, eval_b, _ = make_federated_data(cfg, device="cpu", **DATA_KW)
    got = run_federated(0, cfg, train_b, eval_b, strategy="fednano", rounds=2,
                        hp=HyperParams(**HP), use_pallas=use_pallas, server=_port_server(cfg))
    wl = [m["mean_loss"] for m in want.round_metrics]
    gl = [m["mean_loss"] for m in got.round_metrics]
    for g, w in zip(gl, wl):
        assert abs(g - w) <= TOL * abs(w), (gl, wl)
    assert got.comm_totals == want.comm_totals
    assert got.client_accuracy == want.client_accuracy
    assert_tree_close(got.server.global_adapters, want.server.global_adapters, ADAPTER_TOL,
                      "global adapters")


def test_loss_aux_is_the_balance_loss_and_leaves_the_graph():
    _, _, cfg, params = _backbone(LLAMA4)
    emb = torch.randn(2, 6, cfg.d_model, generator=torch.Generator().manual_seed(1),
                      requires_grad=True)
    pos = torch.arange(6)[None].expand(2, 6)
    labels = torch.zeros((2, 6), dtype=torch.long)
    loss, aux = model_lib.loss_fn(cfg, params, emb, pos, labels, torch.ones(2, 6))
    assert loss.requires_grad and not aux.requires_grad
    assert float(aux) > 0.0


# ---------------------------------------------------------------------------
# configs and the CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_serve_and_train_clis_run_on_cpu(tmp_path, capsys, arch):
    rc = serve.main(["--arch", arch, "--device", "cpu", "--pallas-grouped", "--requests", "4",
                     "--gen-tokens", "5", "--prefill-len", "8", "--slots", "2"])
    assert rc == 0
    assert f"arch={arch} engine: 4 requests, 20 tokens" in capsys.readouterr().out
    rc = train.main(["--arch", arch, "--device", "cpu", "--use-pallas", "--clients", "2",
                     "--rounds", "1", "--local-steps", "1", "--examples-per-client", "8",
                     "--batch-size", "4", "--seq-len", "16", "--out", str(tmp_path)])
    assert rc == 0
    summary = json.loads((tmp_path / f"{arch}_fednano.json").read_text())
    assert np.isfinite(summary["rounds"][0]["mean_loss"])


@pytest.mark.parametrize("arch", MOE)
def test_moe_configs_are_supported(arch):
    cfg = get_smoke_config(arch)
    model_lib.check_supported(cfg)
    assert cfg.family == "moe" and cfg.moe.n_experts == 4
    assert (cfg.act, cfg.logit_softcap) == (("gelu", 30.0) if arch == GROK else ("swiglu", 0.0))


def test_unported_families_name_their_queue():
    """Every family of the JAX package runs in the port: the hybrid and audio
    families, ROADMAP queues 3f and 3g, through their configs. A family, or
    a family's layer combination, that no JAX config has is refused with
    what the port runs."""
    from repro_torch.configs.base import ModelConfig

    for arch in ("recurrentgemma-9b", "whisper-base"):
        model_lib.check_supported(get_smoke_config(arch))
    with pytest.raises(NotImplementedError, match="geglu"):
        model_lib.check_supported(ModelConfig(family="hybrid"))
    with pytest.raises(NotImplementedError, match="layernorm"):
        model_lib.check_supported(ModelConfig(family="audio"))
    with pytest.raises(NotImplementedError, match="'swiglu', 'gelu'"):
        model_lib.check_supported(ModelConfig(family="moe", act="geglu"))
    with pytest.raises(NotImplementedError, match="family"):
        model_lib.check_supported(ModelConfig(family="retnet"))
