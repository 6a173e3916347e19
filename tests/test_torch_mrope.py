"""The port's qwen2-vl-72b against the JAX package: M-RoPE, the QKV bias at
64 heads on 8, and the image prefix of 64 patches through the vlm path.

No entry point of either package feeds (3, B, S) positions: text and image
tokens both get (B, S) positions, which M-RoPE broadcasts to three equal
components, where it equals RoPE. The section plumbing is held here on
distinct (t, h, w) components, as ``tests/test_decode_consistency.py`` does
for the JAX package. Weights are the JAX package's, exported through
``repro_torch.interop``; activations come from numpy seeds; f32. Angles hold
to 1e-6 of their ∞-norm, the model to 1e-5, prefill + decode to 5e-4 (the
JAX package's own bound). Two FedNano rounds: losses to 1e-5, adapters to
``ADAPTER_TOL`` = 1e-4 or ``ROUNDING_MARGIN`` times the port's own f32 run's
distance from an f64 run of the same weights and data, whichever is larger.
AdamW turns rounding into sign-sized steps: on the plain path the text
adapter's ``up`` ends 1.03e-4 from the JAX run's, where the JAX package's
own plain and Pallas runs are 1.12e-4 apart and the port's f32 run is
8.1e-5 from its f64 run (CPU, float32 smoke config).
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import HyperParams as JHyperParams
from repro.core import run_federated as jax_run_federated
from repro.core import server as jserver
from repro.core.comm import CommLog as JCommLog
from repro.data import make_federated_data as jax_make_data
from repro.launch import serve as jax_serve
from repro.models import model as jmodel
from repro.models import rotary as jrotary
from repro.models import vision_stub as jvision
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch import interop
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import HyperParams, ServerState, run_federated
from repro_torch.data import make_federated_data
from repro_torch.launch import serve, train
from repro_torch.models import model as model_lib
from repro_torch.models import rotary, vision_stub
from repro_torch.serving import ServingEngine
from repro_torch.utils import tree_leaves, tree_map
from test_torch_training import assert_tree_close, one_torch_thread, rel_err  # noqa: F401

QWEN2VL = "qwen2-vl-72b"
TOL = 1e-5
ANGLE_TOL = 1e-6
ADAPTER_TOL = 1e-4
ROUNDING_MARGIN = 2.0
TENANTS = ["tenant0", "tenant1"]


@functools.lru_cache(maxsize=None)
def _backbone(seed=0):
    """-> (jax cfg, numpy backbone with nonzero QKV biases, port cfg, port backbone)."""
    jcfg = jax_smoke_config(QWEN2VL)
    tree = jax.tree.map(np.asarray, jmodel.init_backbone(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed + 11)
    a = dict(tree["layers"]["attn"])
    for name in ("bq", "bk", "bv"):  # JAX draws zeros; make the bias matter
        a[name] = (rng.standard_normal(a[name].shape) * 0.5).astype(np.float32)
    tree = dict(tree, layers=dict(tree["layers"], attn=a))
    cfg = get_smoke_config(QWEN2VL)
    return jcfg, tree, cfg, interop.backbone_from_numpy(cfg, tree, "cpu")


def _positions3(B, S, seed):
    """Distinct (t, h, w) components, as an image grid's would be."""
    rng = np.random.default_rng(seed)
    t = np.tile(np.arange(S), (B, 1))
    return np.stack([t, rng.integers(0, 16, (B, S)), rng.integers(0, 16, (B, S))]).astype(
        np.int32)


# ---------------------------------------------------------------------------
# angles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("getter", ["full", "smoke"])
def test_mrope_angles_match_reference(getter):
    cfg = (get_config if getter == "full" else get_smoke_config)(QWEN2VL)
    hd = cfg.resolved_head_dim
    assert sum(cfg.mrope_sections) == hd // 2
    pos3 = _positions3(2, 9, seed=1) * 37  # large positions: the f32 products round
    want = jrotary.mrope_angles(jnp.asarray(pos3), cfg.mrope_sections, hd, cfg.rope_theta)
    got = rotary.mrope_angles(torch.from_numpy(pos3), cfg.mrope_sections, hd, cfg.rope_theta)
    assert got.shape == (2, 9, hd // 2)
    assert rel_err(got, want) <= ANGLE_TOL
    # each slot reads its own component
    t, h, w = cfg.mrope_sections
    inv = rotary.rope_freqs(hd, cfg.rope_theta)
    for c, (lo, hi) in enumerate(((0, t), (t, t + h), (t + h, t + h + w))):
        torch.testing.assert_close(got[..., lo:hi],
                                   torch.from_numpy(pos3[c]).float()[..., None] * inv[lo:hi],
                                   rtol=0, atol=0)


def test_make_angles_on_text_positions_is_rope():
    cfg = get_smoke_config(QWEN2VL)
    pos = torch.arange(12)[None].expand(2, 12)
    got = rotary.make_angles(cfg, pos)
    assert torch.equal(got, rotary.rope_angles(pos, cfg.resolved_head_dim, cfg.rope_theta))
    jcfg = jax_smoke_config(QWEN2VL)
    assert rel_err(got, jrotary.make_angles(jcfg, jnp.asarray(pos.numpy()))) <= ANGLE_TOL
    pos3 = torch.from_numpy(_positions3(2, 12, seed=2))
    got3 = rotary.make_angles(cfg, pos3)
    assert rel_err(got3, jrotary.make_angles(jcfg, jnp.asarray(pos3.numpy()))) <= ANGLE_TOL
    assert float((got3 - got).abs().max()) > 1e-3  # distinct components change the angles


def test_mrope_sections_must_cover_half_the_head():
    with pytest.raises(ValueError, match="sections"):
        rotary.mrope_angles(torch.zeros((3, 1, 2), dtype=torch.long), (16, 24, 20), 128, 1e6)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("positions", ["text", "thw"])
def test_forward_logits_match_reference(positions, use_pallas):
    jcfg, tree, cfg, params = _backbone()
    jcfg, cfg = jcfg.with_(use_pallas=use_pallas), cfg.with_(use_pallas=use_pallas)
    B, S = 2, 12
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    pos = (np.tile(np.arange(S, dtype=np.int32), (B, 1)) if positions == "text"
           else _positions3(B, S, seed=4))
    jparams = jax.tree.map(jnp.asarray, tree)
    jh, _ = jmodel.forward(jcfg, jparams, jmodel.embed_tokens(jcfg, jparams, jnp.asarray(toks)),
                           jnp.asarray(pos))
    emb = model_lib.embed_tokens(cfg, params, torch.from_numpy(toks).long())
    h, aux = model_lib.forward(cfg, params, emb, torch.from_numpy(pos))
    assert float(aux) == 0.0
    assert rel_err(model_lib.logits(cfg, params, h), jmodel.logits(jcfg, jparams, jh)) <= TOL


def test_prefill_with_thw_positions_then_decode_matches_reference():
    """Prefill on distinct (t, h, w) components, then text decode steps, whose
    (B, 1) positions broadcast to three equal components on both sides."""
    jcfg, tree, cfg, params = _backbone()
    B, S, half = 2, 12, 7
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    pos3 = _positions3(B, half, seed=6)
    jparams = jax.tree.map(jnp.asarray, tree)
    jemb = jmodel.embed_tokens(jcfg, jparams, jnp.asarray(toks))
    emb = model_lib.embed_tokens(cfg, params, torch.from_numpy(toks).long())
    jstate, jh = jmodel.prefill(jcfg, jparams, jemb[:, :half], jnp.asarray(pos3), capacity=S)
    state, h = model_lib.prefill(cfg, params, emb[:, :half], torch.from_numpy(pos3), capacity=S)
    assert rel_err(h, jh) <= TOL
    assert rel_err(state["layers"].k[:, :, :half], jstate["layers"].k[:, :, :half]) <= TOL
    for t in range(half, S):
        want, jstate = jmodel.decode_step(jcfg, jparams, jemb[:, t:t + 1], jstate, jnp.int32(t))
        got, state = model_lib.decode_step(cfg, params, emb[:, t:t + 1], state, t)
        assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) < 5e-4, t
        assert rel_err(got, want) <= TOL


# ---------------------------------------------------------------------------
# the image prefix: data, serving, training
# ---------------------------------------------------------------------------

def test_patches_reach_the_model_as_the_reference_feeds_them():
    """64 patches of the ViT's 1280 dims at full width (128 in the smoke
    config), in the data pipeline's batches and in requests."""
    for getter, jget in ((get_config, jax_get_config), (get_smoke_config, jax_smoke_config)):
        cfg, jcfg = getter(QWEN2VL), jget(QWEN2VL)
        assert vision_stub.num_patches(cfg) == jvision.num_patches(jcfg) == 64
        assert cfg.frontend_dim == jcfg.frontend_dim
    assert get_config(QWEN2VL).frontend_dim == 1280
    cfg, jcfg = get_smoke_config(QWEN2VL), jax_smoke_config(QWEN2VL)
    kw = dict(n_clients=2, examples_per_client=8, batch_size=4, seq_len=16, seed=0)
    jtrain, _, _ = jax_make_data(jcfg, **kw)
    train_b, _, _ = make_federated_data(cfg, device="cpu", **kw)
    for got, want in zip(train_b[0], jtrain[0]):
        assert got.patches.shape == (4, 64, 128)
        np.testing.assert_array_equal(got.patches.numpy(), np.asarray(want.patches))
        np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    reqs = serve.make_requests(cfg, TENANTS, 3, 8, 4, 0)
    jreqs = jax_serve.make_requests(jcfg, TENANTS, 3, 8, 4, 0)
    for r, jr in zip(reqs, jreqs):
        assert r.patches.shape == (64, 128)
        np.testing.assert_array_equal(r.patches, jr.patches)


def test_engine_tokens_match_jax_engine():
    jcfg, tree, cfg, backbone = _backbone()
    jcfg, cfg = jcfg.with_(use_pallas=True), cfg.with_(use_pallas=True)
    kw, n = dict(max_slots=3, prefill_len=8, max_new_tokens=4, adapter_slots=4), 6
    jtenants = jax_serve.synth_tenant_adapters(jax.random.PRNGKey(0), jcfg, TENANTS)
    jeng = JaxServingEngine(jcfg, jax.tree.map(jnp.asarray, tree),
                            adapter_loader=jtenants.__getitem__, use_pallas_grouped=True, **kw)
    want = jeng.run(jax_serve.make_requests(jcfg, TENANTS, n, kw["prefill_len"],
                                            kw["max_new_tokens"], 0))
    tenants = {t: interop.adapters_from_numpy(jax.tree.map(np.asarray, a), "cpu")
               for t, a in jtenants.items()}
    eng = ServingEngine(cfg, backbone, adapter_loader=tenants.__getitem__,
                        use_pallas_grouped=True, **kw)
    assert eng.img_prefix == 64
    got = eng.run(serve.make_requests(cfg, TENANTS, n, kw["prefill_len"],
                                      kw["max_new_tokens"], 0))
    assert sorted(got) == sorted(want) == list(range(n))
    for rid in want:
        assert got[rid].tokens == want[rid].tokens, rid


DATA_KW = dict(n_clients=2, examples_per_client=16, batch_size=4, seq_len=16, seed=0)
HP = dict(lr=5e-3, local_steps=2, fisher_batches=2)


@functools.lru_cache(maxsize=None)
def _server():
    jsrv = jserver.init_server(jax.random.PRNGKey(7), jax_smoke_config(QWEN2VL))
    return jsrv, jax.tree.map(np.asarray, jsrv.backbone), jax.tree.map(np.asarray,
                                                                       jsrv.global_adapters)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernels"])
def test_fednano_rounds_match_reference(use_pallas):
    """Text and image adapters over 64 patches + 16 tokens a row."""
    jcfg = jax_smoke_config(QWEN2VL).with_(use_pallas=use_pallas)
    jtrain, jeval, _ = jax_make_data(jcfg, **DATA_KW)
    jsrv, backbone, adapters = _server()
    want = jax_run_federated(jax.random.PRNGKey(0), jcfg, jtrain, jeval, strategy="fednano",
                             rounds=2, hp=JHyperParams(**HP), use_pallas=use_pallas,
                             server=dataclasses.replace(jsrv, comm=JCommLog()))
    cfg = get_smoke_config(QWEN2VL).with_(use_pallas=use_pallas)
    assert sorted(adapters) == ["image", "text"]
    train_b, eval_b, _ = make_federated_data(cfg, device="cpu", **DATA_KW)

    def run(dtype):
        c = cfg.with_(dtype=dtype, adapter=dataclasses.replace(cfg.adapter, dtype=dtype))
        up = (lambda t: t.double()) if dtype == "float64" else (lambda t: t)
        server = ServerState(
            cfg=c, backbone=tree_map(up, interop.backbone_from_numpy(c, backbone, "cpu")),
            global_adapters=tree_map(up, interop.adapters_from_numpy(adapters, "cpu")))
        return run_federated(0, c, train_b, eval_b, strategy="fednano", rounds=2,
                             hp=HyperParams(**HP), use_pallas=use_pallas, server=server)

    got, f64 = run("float32"), run("float64")
    wl = [m["mean_loss"] for m in want.round_metrics]
    gl = [m["mean_loss"] for m in got.round_metrics]
    for g, w in zip(gl, wl):
        assert abs(g - w) <= TOL * abs(w), (gl, wl)
    assert got.comm_totals == want.comm_totals
    witness = max(rel_err(a, b.numpy()) for a, b in zip(
        tree_leaves(got.server.global_adapters), tree_leaves(f64.server.global_adapters)))
    assert_tree_close(got.server.global_adapters, want.server.global_adapters,
                      max(ADAPTER_TOL, ROUNDING_MARGIN * witness), "global adapters")


def test_serve_and_train_clis_run_on_cpu(tmp_path, capsys):
    rc = serve.main(["--arch", QWEN2VL, "--device", "cpu", "--pallas-grouped", "--requests", "3",
                     "--gen-tokens", "4", "--prefill-len", "8", "--slots", "2"])
    assert rc == 0
    assert f"arch={QWEN2VL} engine: 3 requests, 12 tokens" in capsys.readouterr().out
    rc = train.main(["--arch", QWEN2VL, "--device", "cpu", "--use-pallas", "--clients", "2",
                     "--rounds", "1", "--local-steps", "1", "--examples-per-client", "8",
                     "--batch-size", "4", "--seq-len", "16", "--out", str(tmp_path)])
    assert rc == 0
    summary = json.loads((tmp_path / f"{QWEN2VL}_fednano.json").read_text())
    assert np.isfinite(summary["rounds"][0]["mean_loss"])


def test_qwen2_vl_config_is_supported():
    cfg = get_smoke_config(QWEN2VL)
    model_lib.check_supported(cfg)
    assert (cfg.family, cfg.pos_type, cfg.qkv_bias) == ("vlm", "mrope", True)
    assert cfg.mrope_sections == (16, 8, 8) and get_config(QWEN2VL).mrope_sections == (16, 24, 24)
    with pytest.raises(NotImplementedError, match="mrope"):
        model_lib.check_supported(cfg.with_(family="dense"))
