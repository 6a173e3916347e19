"""The port's dense family against the JAX package: h2o-danube-1.8b (sliding
window), glm4-9b and qwen1.5-4b (QKV bias), internlm2-20b.

Weights are the JAX package's, exported through ``repro_torch.interop`` as
numpy; activations come from numpy seeds. JAX initializes the QKV biases to
zero, so where a bias must matter the tests draw it into the exported numpy
tree and give the same tree to both sides. Where the JAX function reaches
Pallas it runs in interpret mode, as the JAX package's own tests run it; on
the CPU the port's kernel wrappers take their plain versions. Everything is
f32. Attention holds to 1e-5 of the reference's ∞-norm; the ring decode to 5e-4 (the JAX package's own bound in
``tests/test_decode_consistency.py``); two FedNano rounds' adapters to
``ADAPTER_TOL`` = 1e-4 (see ``test_torch_training.py``).
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kernel_harness import assert_close as harness_close
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import HyperParams as JHyperParams
from repro.core import run_federated as jax_run_federated
from repro.core import server as jserver
from repro.core.comm import CommLog as JCommLog
from repro.data import make_federated_data as jax_make_data
from repro.kernels.flash_attention import flash_attention as jax_fa
from repro.launch import serve as jax_serve
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.models import rotary as jrotary
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving import generate_naive as jax_generate_naive
from repro_torch import interop
from repro_torch.configs import get_smoke_config
from repro_torch.core import HyperParams, ServerState, run_federated
from repro_torch.data import make_federated_data
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.launch import serve, train
from repro_torch.models import attention as attn
from repro_torch.models import model as model_lib
from repro_torch.models import rotary
from repro_torch.serving import ServingEngine, generate_naive
from test_torch_training import assert_tree_close, one_torch_thread, rel_err  # noqa: F401

H2O, GLM, QWEN, INTERN = "h2o-danube-1.8b", "glm4-9b", "qwen1.5-4b", "internlm2-20b"
DENSE = [H2O, GLM, QWEN, INTERN]
TOL = 1e-5
ADAPTER_TOL = 1e-4
TENANTS = ["tenant0", "tenant1"]


def _bias_tree(tree, seed):
    """The exported backbone with nonzero q/k/v biases where it has them."""
    rng = np.random.default_rng(seed)
    a = dict(tree["layers"]["attn"])
    for name in ("bq", "bk", "bv"):
        if name in a:
            a[name] = (rng.standard_normal(a[name].shape) * 0.5).astype(np.float32)
    return dict(tree, layers=dict(tree["layers"], attn=a))


@functools.lru_cache(maxsize=None)
def _backbone(arch, seed=0):
    """-> (jax cfg, numpy backbone with drawn biases, port cfg, port backbone)."""
    jcfg = jax_smoke_config(arch)
    tree = jax.tree.map(np.asarray, jmodel.init_backbone(jax.random.PRNGKey(seed), jcfg))
    tree = _bias_tree(tree, seed + 11)
    cfg = get_smoke_config(arch)
    return jcfg, tree, cfg, interop.backbone_from_numpy(cfg, tree, "cpu")


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

ATTN_CASES = [
    # (id, arch, sequence length)
    ("glm4-bias", GLM, 24),
    ("qwen1.5-bias-mha", QWEN, 24),
    ("h2o-window-s80", H2O, 80),
    ("internlm2-gqa", INTERN, 24),
]


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("case", ATTN_CASES, ids=[c[0] for c in ATTN_CASES])
def test_full_attention_matches_reference(case, use_pallas):
    _, arch, S = case
    jcfg, tree, cfg, params = _backbone(arch)
    jcfg = jcfg.with_(use_pallas=use_pallas)
    cfg = cfg.with_(use_pallas=use_pallas)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (2, 1))
    hd, theta = cfg.resolved_head_dim, cfg.rope_theta
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["layers"]["attn"])
    if arch in (GLM, QWEN):
        assert float(jnp.abs(jp["bk"]).max()) > 0  # the bias is live on both sides
    want, (wk, wv) = jattn.full_attention(
        jcfg, jp, jnp.asarray(x), jrotary.rope_angles(jnp.asarray(pos), hd, theta),
        return_kv=True)
    got, (gk, gv) = attn.full_attention(
        cfg, params["layers"][0]["attn"], torch.from_numpy(x),
        rotary.rope_angles(torch.from_numpy(pos).long(), hd, theta), return_kv=True)
    for what, g, w in (("out", got, want), ("k", gk, wk), ("v", gv, wv)):
        assert rel_err(g, w) <= TOL, what


def test_window_masks_keys():
    """At S = 80 > the smoke window of 64 the window changes the output (the
    cases above would pass with a window that masks nothing otherwise)."""
    _, _, cfg, params = _backbone(H2O)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 80, cfg.d_model))
                         .astype(np.float32))
    ang = rotary.rope_angles(torch.arange(80)[None], cfg.resolved_head_dim, cfg.rope_theta)
    lp = params["layers"][0]["attn"]
    windowed = attn.full_attention(cfg, lp, x, ang)
    full = attn.full_attention(cfg.with_(sliding_window=None), lp, x, ang)
    assert torch.equal(windowed[:, :64], full[:, :64])
    assert float((windowed[:, 64:] - full[:, 64:]).abs().max()) > 1e-3


def test_flash_plain_version_matches_pallas_at_head_dim_80():
    rng = np.random.default_rng(80)
    q = rng.standard_normal((1, 40, 4, 80)).astype(np.float32)
    k, v = (rng.standard_normal((1, 40, 1, 80)).astype(np.float32) for _ in range(2))
    want, want_lse = jax_fa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, window=16, softcap=0.0,
        block_q=16, block_k=16, interpret=True, return_lse=True)
    got, got_lse = fa_ref.attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=True, window=16,
                                    return_lse=True)
    harness_close(got.numpy(), want, kernel="flash_attention", dtype=jnp.float32,
                  err_msg="d80 window 16")
    harness_close(got_lse.numpy(), want_lse, kernel="flash_attention", dtype=jnp.float32,
                  err_msg="d80 window 16 lse")


def test_init_attention_biases():
    cfg = get_smoke_config(GLM)
    gen = torch.Generator().manual_seed(0)
    p = attn.init_attention(gen, cfg, torch.float32)
    hd = cfg.resolved_head_dim
    assert p["bq"].shape == (cfg.n_heads * hd,) and p["bk"].shape == (cfg.n_kv_heads * hd,)
    assert all(float(p[n].abs().max()) == 0.0 for n in ("bq", "bk", "bv"))
    assert "bq" not in attn.init_attention(gen, get_smoke_config(INTERN), torch.float32)


def test_interop_carries_qkv_biases():
    _, tree, cfg, params = _backbone(QWEN)
    for i in range(cfg.n_layers):
        np.testing.assert_array_equal(params["layers"][i]["attn"]["bv"].numpy(),
                                      tree["layers"]["attn"]["bv"][i])
    back = interop.backbone_to_numpy(params, cfg)
    for name in ("bq", "bk", "bv"):
        np.testing.assert_array_equal(back["layers"]["attn"][name], tree["layers"]["attn"][name])


@functools.lru_cache(maxsize=None)
def _server(arch):
    jsrv = jserver.init_server(jax.random.PRNGKey(7), jax_smoke_config(arch))
    return jsrv, jax.tree.map(np.asarray, jsrv.backbone), jax.tree.map(np.asarray,
                                                                       jsrv.global_adapters)


def _port_server(cfg):
    _, backbone, adapters = _server(cfg.name)
    return ServerState(cfg=cfg, backbone=interop.backbone_from_numpy(cfg, backbone, "cpu"),
                       global_adapters=interop.adapters_from_numpy(adapters, "cpu"))


# ---------------------------------------------------------------------------
# the sliding-window ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel"])
def test_swa_ring_buffer_long_decode(use_pallas):
    """Prefill w + 4 positions (the seeded ring rolls), decode to 2w + 8 (past
    two wraps): every step's logits equal the JAX package's full forward. The
    prefill takes the flash wrapper's path when ``use_pallas`` is set."""
    jcfg, tree, cfg, params = _backbone(H2O)
    cfg = cfg.with_(use_pallas=use_pallas)
    w = cfg.sliding_window
    S, half = 2 * w + 8, w + 4
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (1, S)).astype(np.int32)
    jparams = jax.tree.map(jnp.asarray, tree)
    pos = jnp.arange(S)[None]
    jemb = jmodel.embed_tokens(jcfg, jparams, jnp.asarray(toks))
    want = np.asarray(jmodel.logits(jcfg, jparams, jmodel.forward(jcfg, jparams, jemb, pos)[0]))

    emb = model_lib.embed_tokens(cfg, params, torch.from_numpy(toks).long())
    state, _ = model_lib.prefill(cfg, params, emb[:, :half], torch.arange(half)[None],
                                 capacity=S)
    assert state["layers"].k.shape[2] == w  # the cache is a ring of the window
    for t in range(half, S):
        got, state = model_lib.decode_step(cfg, params, emb[:, t:t + 1], state, t)
        err = float(np.max(np.abs(got[:, 0].numpy() - want[:, t])))
        assert err < 5e-4, f"ring decode diverges at t={t}: {err}"


def test_seed_cache_rolls_a_long_prefill():
    C, S = 4, 10
    k = torch.arange(S, dtype=torch.float32).reshape(1, S, 1, 1)
    cache = attn.KVCache(torch.zeros(1, C, 1, 1), torch.zeros(1, C, 1, 1))
    attn.seed_cache(cache, k, k + 100)
    # positions 6..9 at slots p % 4
    assert cache.k.flatten().tolist() == [8.0, 9.0, 6.0, 7.0]
    assert cache.v.flatten().tolist() == [108.0, 109.0, 106.0, 107.0]


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

# h2o: 56 new tokens after prompts of 2 to 17 tokens carry positions past the
# 64-slot ring; glm4 with nonzero QKV biases.
TRAFFIC = {H2O: (dict(max_slots=3, prefill_len=40, max_new_tokens=56, adapter_slots=4), 6),
           GLM: (dict(max_slots=3, prefill_len=8, max_new_tokens=4, adapter_slots=4), 6)}


@pytest.mark.parametrize("arch", list(TRAFFIC))
def test_engine_tokens_match_jax_engine(arch):
    kw, n = TRAFFIC[arch]
    jcfg, tree, cfg, backbone = _backbone(arch)
    jcfg, cfg = jcfg.with_(use_pallas=True), cfg.with_(use_pallas=True)
    jtenants = jax_serve.synth_tenant_adapters(jax.random.PRNGKey(0), jcfg, TENANTS)
    jeng = JaxServingEngine(jcfg, jax.tree.map(jnp.asarray, tree),
                            adapter_loader=jtenants.__getitem__, use_pallas_grouped=True, **kw)
    want = jeng.run(jax_serve.make_requests(jcfg, TENANTS, n, kw["prefill_len"],
                                            kw["max_new_tokens"], 0))
    tenants = {t: interop.adapters_from_numpy(jax.tree.map(np.asarray, a), "cpu")
               for t, a in jtenants.items()}
    eng = ServingEngine(cfg, backbone, adapter_loader=tenants.__getitem__,
                        use_pallas_grouped=True, **kw)
    reqs = serve.make_requests(cfg, TENANTS, n, kw["prefill_len"], kw["max_new_tokens"], 0)
    got = eng.run(reqs)
    assert sorted(got) == sorted(want) == list(range(n))
    for rid in want:
        assert got[rid].tokens == want[rid].tokens, rid
    if cfg.sliding_window is not None:
        ring = eng.slots.state["layers"].k.shape[2]
        assert ring == cfg.sliding_window < eng.capacity
        assert max(len(r.prompt) + kw["max_new_tokens"] for r in reqs) > ring  # decode wraps


def test_naive_loop_matches_jax_naive_loop_across_the_ring():
    """h2o's one-request-at-a-time loop, decoding past its 64-slot ring: the
    JAX loop's tokens, and the port engine's."""
    kw, n = TRAFFIC[H2O]
    jcfg, tree, cfg, backbone = _backbone(H2O)
    jtenants = jax_serve.synth_tenant_adapters(jax.random.PRNGKey(0), jcfg, TENANTS)
    want = jax_generate_naive(jcfg, jax.tree.map(jnp.asarray, tree),
                              jax_serve.make_requests(jcfg, TENANTS, n, kw["prefill_len"],
                                                      kw["max_new_tokens"], 0), jtenants)
    tenants = {t: interop.adapters_from_numpy(jax.tree.map(np.asarray, a), "cpu")
               for t, a in jtenants.items()}
    reqs = serve.make_requests(cfg, TENANTS, n, kw["prefill_len"], kw["max_new_tokens"], 0)
    got = generate_naive(cfg, backbone, reqs, tenants)
    eng = ServingEngine(cfg.with_(use_pallas=True), backbone, adapter_loader=tenants.__getitem__,
                        use_pallas_grouped=True, **kw).run(reqs)
    assert max(len(r.prompt) + kw["max_new_tokens"] for r in reqs) > cfg.sliding_window
    for rid in want:
        assert got[rid].tokens == want[rid].tokens == eng[rid].tokens, rid


def test_window_guard_rejects_pad_overflow():
    """A padded prefill longer than the window would let pad KV evict live
    ring entries: the engine refuses to build (``tests/test_serving.py``)."""
    _, _, cfg, backbone = _backbone(H2O)
    with pytest.raises(ValueError, match="window"):
        ServingEngine(cfg, backbone, max_slots=1, prefill_len=cfg.sliding_window + 1,
                      max_new_tokens=4)
    ServingEngine(cfg, backbone, max_slots=1, prefill_len=cfg.sliding_window, max_new_tokens=4)


# ---------------------------------------------------------------------------
# training: two FedNano rounds of h2o-danube past its window
# ---------------------------------------------------------------------------

DATA_KW = dict(n_clients=2, examples_per_client=8, batch_size=4, seq_len=80, seed=0)
HP = dict(lr=5e-3, local_steps=2, fisher_batches=2)


@functools.lru_cache(maxsize=None)
def _jax_run(use_pallas):
    jcfg = jax_smoke_config(H2O).with_(use_pallas=use_pallas)
    jtrain, jeval, _ = jax_make_data(jcfg, **DATA_KW)
    jsrv = dataclasses.replace(_server(H2O)[0], comm=JCommLog())
    return jax_run_federated(jax.random.PRNGKey(0), jcfg, jtrain, jeval, strategy="fednano",
                             rounds=2, hp=JHyperParams(**HP), use_pallas=use_pallas,
                             server=jsrv)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernels"])
def test_h2o_fednano_rounds_match_reference(use_pallas):
    want = _jax_run(use_pallas)
    cfg = get_smoke_config(H2O).with_(use_pallas=use_pallas)
    train_b, eval_b, _ = make_federated_data(cfg, device="cpu", **DATA_KW)
    assert train_b[0][0].tokens.shape[1] > cfg.sliding_window
    got = run_federated(0, cfg, train_b, eval_b, strategy="fednano", rounds=2,
                        hp=HyperParams(**HP), use_pallas=use_pallas, server=_port_server(cfg))
    wl = [m["mean_loss"] for m in want.round_metrics]
    gl = [m["mean_loss"] for m in got.round_metrics]
    for g, w in zip(gl, wl):
        assert abs(g - w) <= TOL * abs(w), (gl, wl)
    assert got.comm_totals == want.comm_totals
    assert_tree_close(got.server.global_adapters, want.server.global_adapters, ADAPTER_TOL,
                      "global adapters")


# ---------------------------------------------------------------------------
# configs and the CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_dense_configs_run_rope_rmsnorm_swiglu(arch):
    cfg = get_smoke_config(arch)
    model_lib.check_supported(cfg)
    assert cfg.family == "dense" and cfg.frontend_dim == 0


@pytest.mark.parametrize("arch", [H2O, GLM])
def test_serve_and_train_clis_run_on_cpu(tmp_path, capsys, arch):
    rc = serve.main(["--arch", arch, "--device", "cpu", "--pallas-grouped", "--requests", "4",
                     "--gen-tokens", "30", "--prefill-len", "40", "--slots", "2"])
    assert rc == 0
    assert f"arch={arch} engine: 4 requests, 120 tokens" in capsys.readouterr().out
    rc = train.main(["--arch", arch, "--device", "cpu", "--use-pallas", "--clients", "2",
                     "--rounds", "1", "--local-steps", "1", "--examples-per-client", "8",
                     "--batch-size", "4", "--seq-len", "80", "--out", str(tmp_path)])
    assert rc == 0
    summary = json.loads((tmp_path / f"{arch}_fednano.json").read_text())
    assert np.isfinite(summary["rounds"][0]["mean_loss"])


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")


@pytest.mark.parametrize("arch", [H2O, GLM])
def test_entry_points_default_to_cuda(no_cuda, arch):
    with pytest.raises((RuntimeError, AssertionError)):
        serve.main(["--arch", arch])
    with pytest.raises((RuntimeError, AssertionError)):
        train.main(["--arch", arch, "--rounds", "1", "--clients", "2", "--local-steps", "1",
                    "--examples-per-client", "8", "--batch-size", "4", "--seq-len", "8"])
