"""The port's model modules against the JAX package on smoke llava-1.5-7b.

The JAX package draws the weights; they reach the port through
``repro_torch.interop`` as numpy arrays. Activations come from numpy seeds.
Everything runs in f32 on the CPU and agrees to 1e-5 of the reference's
∞-norm (``TOL``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import adapters as jnano
from repro.core.types import Batch as JBatch
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import rotary as jrotary
from repro_torch import interop
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import adapters as nano
from repro_torch.core.types import Batch
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import model as model_lib
from repro_torch.models import rotary

ARCH = "llava-1.5-7b"
TOL = 1e-5


def assert_close(got, want, tol=TOL, what=""):
    g = got.float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    err = float(np.max(np.abs(g - w)))
    bound = tol * float(np.max(np.abs(w)))
    assert err <= bound, f"{what}: max |err| {err:.3e} > {bound:.3e}"


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg = jax_smoke_config(ARCH)
    key = jax.random.PRNGKey(0)
    jparams = jmodel.init_backbone(key, jcfg)
    jad = jnano.init_nanoedge(jax.random.fold_in(key, 1), jcfg)
    rng = np.random.default_rng(5)  # non-zero up: the adapters must matter
    jad = {m: {"down": np.asarray(a["down"]),
               "up": (rng.standard_normal(a["up"].shape) * 0.05).astype(np.float32)}
           for m, a in jad.items()}
    cfg = get_smoke_config(ARCH)
    params = interop.backbone_from_numpy(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    ad = interop.adapters_from_numpy(jad, "cpu")
    jad = jax.tree.map(jnp.asarray, jad)
    return jcfg, jparams, jad, cfg, params, ad


def _batch(cfg, seed=0, seq=8):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (1, seq)).astype(np.int32)
    patches = rng.standard_normal((1, 64, cfg.frontend_dim)).astype(np.float32)
    jb = JBatch(tokens=jnp.asarray(tokens), labels=jnp.asarray(tokens),
                mask=jnp.ones(tokens.shape, jnp.float32), patches=jnp.asarray(patches))
    tb = Batch(tokens=torch.from_numpy(tokens).long(), labels=torch.from_numpy(tokens).long(),
               mask=torch.ones(tokens.shape), patches=torch.from_numpy(patches))
    return jb, tb


@pytest.mark.parametrize("arch", [ARCH, "mamba2-130m", "minigpt4-7b", "h2o-danube-1.8b", "glm4-9b",
                                  "qwen1.5-4b", "internlm2-20b", "qwen2-vl-72b",
                                  "llama4-scout-17b-a16e", "grok-1-314b", "recurrentgemma-9b",
                                  "whisper-base"])
@pytest.mark.parametrize("getter", ["full", "smoke"])
def test_configs_match_reference(getter, arch):
    mine = (get_config if getter == "full" else get_smoke_config)(arch)
    ref = (jax_get_config if getter == "full" else jax_smoke_config)(arch)
    for f in dataclasses.fields(mine):
        want = getattr(ref, f.name)
        got = getattr(mine, f.name)
        if f.name in ("adapter", "ssm", "moe", "rglru") and got is not None:  # the port's own
            assert want is not None, f.name
            for a in dataclasses.fields(got):
                assert getattr(got, a.name) == getattr(want, a.name), f"{f.name}.{a.name}"
        else:
            assert got == want, f.name


def test_every_reference_config_is_in_the_port():
    from repro.configs import list_archs as jax_list_archs
    from repro_torch.configs import list_archs

    assert sorted(list_archs()) == sorted(jax_list_archs())


# the stacked layouts: the hybrid family's triples with and without extras,
# and the encoder-decoder's two stacks
LAYOUTS = [("recurrentgemma-9b", {}, {"triples": 1, "extras": None}),
           ("recurrentgemma-9b", {"n_layers": 5}, {"triples": 1, "extras": 2}),
           ("whisper-base", {}, {"enc_layers": 2, "dec_layers": 2})]


@pytest.mark.parametrize("arch,kw,stacks", LAYOUTS, ids=["hybrid-3", "hybrid-5", "encdec"])
def test_interop_round_trips_the_stacked_layout(arch, kw, stacks):
    """Every leaf out and back bit for bit, each stack a list of its depth
    (None for a hybrid stack without extras), and a stack whose leading axis
    disagrees with the config refused in both directions."""
    jcfg = jax_smoke_config(arch, **kw)
    tree = jax.tree.map(np.asarray, jmodel.init_backbone(jax.random.PRNGKey(2), jcfg))
    cfg = get_smoke_config(arch, **kw)
    params = interop.backbone_from_numpy(cfg, tree, "cpu")
    for name, n in stacks.items():
        assert (params[name] if n is None else len(params[name])) == n, name
    back = interop.backbone_to_numpy(params, cfg)
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    wrong = cfg.with_(n_layers=cfg.n_layers + 3)
    moved = "dec_layers" if "dec_layers" in stacks else "triples"
    with pytest.raises(ValueError, match=f"stacked {moved} axis"):
        interop.backbone_from_numpy(wrong, tree, "cpu")
    with pytest.raises(ValueError, match=f"stacked {moved} axis"):
        interop.backbone_to_numpy(params, wrong)


def test_rmsnorm():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 256)).astype(np.float32) * 3
    s = rng.standard_normal(256).astype(np.float32)
    want = jlayers.rmsnorm({"scale": jnp.asarray(s)}, jnp.asarray(x))
    got = layers.rmsnorm({"scale": torch.from_numpy(s)}, torch.from_numpy(x))
    assert_close(got, want, what="rmsnorm")


def test_apply_rotary():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 4, 64)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 6)).astype(np.int32)
    want = jrotary.apply_rotary(jnp.asarray(x), jrotary.rope_angles(jnp.asarray(pos), 64, 1e4))
    got = rotary.apply_rotary(torch.from_numpy(x),
                              rotary.rope_angles(torch.from_numpy(pos).long(), 64, 1e4))
    assert_close(got, want, what="apply_rotary")


@pytest.mark.parametrize("use_pallas", [False, True], ids=["sdpa", "flash"])
def test_full_attention(use_pallas):
    jcfg, jparams, _, cfg, params, _ = _setup()
    jcfg, cfg = jcfg.with_(use_pallas=use_pallas), cfg.with_(use_pallas=use_pallas)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(12, dtype=np.int32), (2, 1))
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["attn"])
    want, (wk, wv) = jattn.full_attention(
        jcfg, jp, jnp.asarray(x), jrotary.rope_angles(jnp.asarray(pos), 64, 1e4),
        return_kv=True)
    got, (gk, gv) = attn.full_attention(
        cfg, params["layers"][0]["attn"], torch.from_numpy(x),
        rotary.rope_angles(torch.from_numpy(pos).long(), 64, 1e4), return_kv=True)
    assert_close(got, want, what="attention out")
    assert_close(gk, wk, what="k")
    assert_close(gv, wv, what="v")


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel"])
def test_nanoedge_forward(use_pallas):
    jcfg, jparams, jad, cfg, params, ad = _setup()
    jb, tb = _batch(cfg)
    want = jnano.nanoedge_forward(jcfg.with_(use_pallas=use_pallas), jparams, jad, jb)
    got = nano.nanoedge_forward(cfg.with_(use_pallas=use_pallas), params, ad, tb)
    for name, g, w in zip(("embeds", "positions", "labels", "mask"), got[:4], want[:4]):
        assert_close(g, w, what=name)
    assert got[4] is None and want[4] is None


@functools.lru_cache(maxsize=None)
def _prefilled(use_pallas):
    jcfg, jparams, jad, cfg, params, ad = _setup()
    jcfg, cfg = jcfg.with_(use_pallas=use_pallas), cfg.with_(use_pallas=use_pallas)
    jb, tb = _batch(cfg, seed=4)
    je, jpos, *_ = jnano.nanoedge_forward(jcfg, jparams, jad, jb)
    te, tpos, *_ = nano.nanoedge_forward(cfg, params, ad, tb)
    cap = je.shape[1] + 4
    jstate, jh = jmodel.prefill(jcfg, jparams, je, jpos, cap)
    tstate, th = model_lib.prefill(cfg, params, te, tpos, cap)
    return jstate, jh, tstate, th


@pytest.mark.parametrize("use_pallas", [False, True], ids=["sdpa", "flash"])
def test_prefill_hidden_and_kv(use_pallas):
    jstate, jh, tstate, th = _prefilled(use_pallas)
    assert_close(th, jh, what="hidden")
    assert_close(tstate["layers"].k, jstate["layers"].k, what="cache k")
    assert_close(tstate["layers"].v, jstate["layers"].v, what="cache v")


def test_decode_step_logits():
    jcfg, jparams, _, cfg, params, _ = _setup()
    jstate, jh, tstate, th = _prefilled(False)
    S = jh.shape[1]
    tok = np.array([[7]], np.int32)
    jemb = jmodel.embed_tokens(jcfg, jparams, jnp.asarray(tok))
    temb = model_lib.embed_tokens(cfg, params, torch.from_numpy(tok).long())
    jlg, jstate2 = jmodel.decode_step(jcfg, jparams, jemb, jstate, jnp.int32(S))
    state = {"layers": attn.KVCache(tstate["layers"].k.clone(), tstate["layers"].v.clone())}
    tlg, state = model_lib.decode_step(cfg, params, temb, state, S)
    assert_close(tlg, jlg, what="decode logits")
    assert_close(state["layers"].k, jstate2["layers"].k, what="cache k after decode")


def test_decode_step_per_row_positions():
    """One decode over two rows at different positions equals each row's own
    B=1 decode in the JAX package (the engine's vmap over pages)."""
    jcfg, jparams, _, cfg, params, _ = _setup()
    C = 16
    rng = np.random.default_rng(6)
    shape = (cfg.n_layers, 2, C, cfg.n_kv_heads, cfg.resolved_head_dim)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    toks = np.array([[3], [11]], np.int32)
    pos = np.array([5, 9])
    state = {"layers": attn.KVCache(torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy()))}
    emb = model_lib.embed_tokens(cfg, params, torch.from_numpy(toks).long())
    lg, state = model_lib.decode_step(cfg, params, emb, state, torch.from_numpy(pos))
    for b in range(2):
        jstate = {"layers": jattn.KVCache(jnp.asarray(k0[:, b:b + 1]), jnp.asarray(v0[:, b:b + 1]))}
        jemb = jmodel.embed_tokens(jcfg, jparams, jnp.asarray(toks[b:b + 1]))
        jlg, jstate = jmodel.decode_step(jcfg, jparams, jemb, jstate, jnp.int32(pos[b]))
        assert_close(lg[b:b + 1], jlg, what=f"row {b} logits")
        assert_close(state["layers"].k[:, b:b + 1], jstate["layers"].k, what=f"row {b} cache")
