"""The port's serving slice against the JAX package's serving engine.

The slice test runs both ``ServingEngine``s on the same smoke backbone,
tenant adapters and ``make_requests`` traffic, the JAX engine with its
Pallas kernels in interpret mode and the port with ``use_pallas`` (on the
CPU its kernels' plain versions), and requires identical tokens: on
llava-1.5-7b and on mamba2-130m, whose prompts (2 to 35 tokens, padded to
40) cross its 32-step SSD chunk and include one shorter than the conv
window. The one-request-at-a-time loop (``generate_naive``) gives the JAX
loop's tokens and the port engine's. Tenants come from the JAX package's
checkpoints through ``checkpoint_adapter_loader``. The rest are the
pure-Python parts: the adapter cache, the page pool, and the CLIs.
"""
import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import server as jserver
from repro.launch import serve as jax_serve
from repro.models import model as jmodel
from repro.serving import AdapterBank as JAdapterBank
from repro.serving import AdapterCache as JAdapterCache
from repro.serving import KVSlotManager as JKVSlotManager
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving import checkpoint_adapter_loader as jax_checkpoint_adapter_loader
from repro.serving import generate_naive as jax_generate_naive
from repro_torch import interop
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve, train
from repro_torch.models import model as model_lib
from repro_torch.serving import (
    AdapterBank,
    AdapterCache,
    AdapterCacheMiss,
    KVSlotManager,
    ServingEngine,
    checkpoint_adapter_loader,
    generate_naive,
    grouped_adapter_apply,
)

from test_torch_training import one_torch_thread  # noqa: F401  (autouse fixture)

ARCH = "llava-1.5-7b"
TENANTS = ["tenant0", "tenant1"]
ENGINE_KW = dict(max_slots=3, prefill_len=8, max_new_tokens=4, adapter_slots=4)
# per arch: (engine settings, number of requests)
TRAFFIC = {ARCH: (ENGINE_KW, 6),
           "mamba2-130m": (dict(ENGINE_KW, prefill_len=40), 12)}


@functools.lru_cache(maxsize=None)
def _jax_side(arch=ARCH):
    jcfg = jax_smoke_config(arch).with_(use_pallas=True)
    key = jax.random.PRNGKey(0)
    backbone = jmodel.init_backbone(key, jcfg)
    tenants = jax_serve.synth_tenant_adapters(key, jcfg, TENANTS)
    return jcfg, backbone, tenants


def _requests(make, arch=ARCH):
    jcfg = jax_smoke_config(arch)
    kw, n = TRAFFIC[arch]
    return make(jcfg, TENANTS, n, kw["prefill_len"], kw["max_new_tokens"], 0)


def test_make_requests_matches_reference():
    mine, ref = _requests(serve.make_requests), _requests(jax_serve.make_requests)
    assert [r.tenant for r in mine] == [r.tenant for r in ref]
    assert None in [r.tenant for r in mine]  # base-model traffic is part of the mix
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a.prompt, b.prompt)
        np.testing.assert_array_equal(a.patches, b.patches)
        assert a.max_new_tokens == b.max_new_tokens


def _port_side(arch=ARCH):
    """The JAX side's backbone and tenants in the port, on the CPU."""
    jcfg, jbackbone, jtenants = _jax_side(arch)
    cfg = get_smoke_config(arch).with_(use_pallas=True)
    backbone = interop.backbone_from_numpy(cfg, jax.tree.map(np.asarray, jbackbone), "cpu")
    tenants = {t: interop.adapters_from_numpy(jax.tree.map(np.asarray, a), "cpu")
               for t, a in jtenants.items()}
    return cfg, backbone, tenants


@pytest.mark.parametrize("arch", list(TRAFFIC))
def test_engine_tokens_match_jax_engine(arch):
    kw, n = TRAFFIC[arch]
    jcfg, jbackbone, jtenants = _jax_side(arch)
    jeng = JaxServingEngine(jcfg, jbackbone, adapter_loader=jtenants.__getitem__,
                            use_pallas_grouped=True, **kw)
    want = jeng.run(_requests(jax_serve.make_requests, arch))

    cfg, backbone, tenants = _port_side(arch)
    eng = ServingEngine(cfg, backbone, adapter_loader=tenants.__getitem__,
                        use_pallas_grouped=True, **kw)
    reqs = _requests(serve.make_requests, arch)
    assert min(len(r.prompt) for r in reqs) == 2
    got = eng.run(reqs)

    assert sorted(got) == sorted(want) == list(range(n))
    for rid in want:
        assert got[rid].tokens == want[rid].tokens, rid
        assert len(got[rid].tokens) == kw["max_new_tokens"]
    assert eng.stats["prefills"] == jeng.stats["prefills"] == n
    assert eng.stats["decode_steps"] == jeng.stats["decode_steps"]
    assert eng.mean_occupancy() > 1.0


@pytest.mark.parametrize("arch", list(TRAFFIC))
def test_naive_loop_matches_jax_naive_loop_and_engine(arch):
    """Unpadded prefill at every prompt length, then one decode step a token
    with the text adapter applied between steps: the JAX loop's tokens, and
    the port engine's."""
    kw, n = TRAFFIC[arch]
    jcfg, jbackbone, jtenants = _jax_side(arch)
    want = jax_generate_naive(jcfg, jbackbone, _requests(jax_serve.make_requests, arch),
                              jtenants)
    cfg, backbone, tenants = _port_side(arch)
    reqs = _requests(serve.make_requests, arch)
    got = generate_naive(cfg, backbone, reqs, tenants)
    eng = ServingEngine(cfg, backbone, adapter_loader=tenants.__getitem__,
                        use_pallas_grouped=True, **kw).run(reqs)
    assert sorted(got) == sorted(want) == sorted(eng) == list(range(n))
    for rid in want:
        assert got[rid].tokens == want[rid].tokens == eng[rid].tokens, rid
        assert len(got[rid].tokens) == kw["max_new_tokens"]


def test_naive_loop_stop_token_and_identity_tenant():
    cfg, backbone, tenants = _port_side()
    reqs = _requests(serve.make_requests)[:2]
    free_run = generate_naive(cfg, backbone, reqs, tenants)
    stop = free_run[0].tokens[1]
    stopped = generate_naive(cfg, backbone, reqs, tenants, stop_token=stop)
    assert stopped[0].tokens == free_run[0].tokens[:free_run[0].tokens.index(stop) + 1]
    # a tenant without adapters serves with the identity set, as tenant None
    ghost = [serve.Request(rid=9, tenant="ghost", prompt=reqs[0].prompt,
                           patches=reqs[0].patches, max_new_tokens=3)]
    base = [serve.Request(rid=9, tenant=None, prompt=reqs[0].prompt,
                          patches=reqs[0].patches, max_new_tokens=3)]
    assert generate_naive(cfg, backbone, ghost, tenants)[9].tokens == \
        generate_naive(cfg, backbone, base)[9].tokens


def test_engine_matches_naive_with_a_prompt_at_prefill_len():
    cfg, backbone, tenants = _port_side()
    kw, _ = TRAFFIC[ARCH]
    rng = np.random.default_rng(9)
    reqs = _requests(serve.make_requests)[:3]
    reqs[0].prompt = rng.integers(0, cfg.vocab_size, kw["prefill_len"]).astype(np.int32)
    eng = ServingEngine(cfg, backbone, adapter_loader=tenants.__getitem__,
                        use_pallas_grouped=True, **kw).run(reqs)
    naive = generate_naive(cfg, backbone, reqs, tenants)
    assert len(reqs[0].prompt) == kw["prefill_len"]
    assert all(eng[r.rid].tokens == naive[r.rid].tokens for r in reqs)


def _jax_tenant_root(root, jcfg, jbackbone, jtenants):
    """tenant0 as a JAX server checkpoint directory, tenant1 as a bare npz."""
    srv = jserver.ServerState(cfg=jcfg, backbone=jbackbone,
                              global_adapters=jtenants[TENANTS[0]])
    jckpt.save_server_checkpoint(os.path.join(root, TENANTS[0]), srv, round_idx=1)
    jckpt.save_pytree(os.path.join(root, TENANTS[1] + ".npz"), jtenants[TENANTS[1]])


def test_checkpoint_loader_reads_jax_tenants(tmp_path):
    """Tenants written by the JAX package, served through each package's
    ``checkpoint_adapter_loader``: the same tokens."""
    kw, n = TRAFFIC[ARCH]
    jcfg, jbackbone, jtenants = _jax_side()
    root = str(tmp_path / "tenants")
    _jax_tenant_root(root, jcfg, jbackbone, jtenants)
    want = JaxServingEngine(jcfg, jbackbone, use_pallas_grouped=True,
                            adapter_loader=jax_checkpoint_adapter_loader(jcfg, root), **kw).run(
        _requests(jax_serve.make_requests))
    cfg, backbone, tenants = _port_side()
    loader = checkpoint_adapter_loader(cfg, root)
    for t in TENANTS:
        got = loader(t)
        assert all(torch.equal(got[m][k], tenants[t][m][k]) for m in got for k in got[m])
    eng = ServingEngine(cfg, backbone, adapter_loader=loader, use_pallas_grouped=True, **kw)
    got = eng.run(_requests(serve.make_requests))
    assert eng.cache.stats()["misses"] == len(TENANTS)
    for rid in range(n):
        assert got[rid].tokens == want[rid].tokens, rid


def test_engine_prefill_logits_pick_first_token():
    cfg = get_smoke_config(ARCH)
    eng = ServingEngine(cfg, model_lib.init_backbone(cfg, seed=0, device="cpu"), **ENGINE_KW)
    reqs = _requests(serve.make_requests)[:2]
    for r in reqs:
        r.tenant = None  # base model: no loader needed
    done = eng.run(reqs)
    for r in reqs:
        lg = eng.prefill_logits(r)
        assert lg.shape == (cfg.vocab_size,) and lg.dtype == torch.float32
        assert int(torch.argmax(lg)) == done[r.rid].tokens[0]


def test_engine_stop_token_and_budget():
    cfg = get_smoke_config(ARCH)
    backbone = model_lib.init_backbone(cfg, seed=0, device="cpu")
    reqs = _requests(serve.make_requests)[4:5]  # the base-model request
    free_run = ServingEngine(cfg, backbone, **ENGINE_KW).run(reqs)[4].tokens
    assert len(free_run) == ENGINE_KW["max_new_tokens"]  # budget respected
    stop = free_run[1]
    stopped = ServingEngine(cfg, backbone, stop_token=stop, **ENGINE_KW).run(reqs)[4].tokens
    assert stopped == free_run[:free_run.index(stop) + 1]


# ---------------------------------------------------------------------------
# adapter bank / cache
# ---------------------------------------------------------------------------

def _bank(n_slots):
    cfg = get_smoke_config(ARCH)
    return cfg, AdapterBank(cfg, n_slots, "cpu")


def _adapters(cfg, seed):
    return serve.synth_tenant_adapters(seed, cfg, ["t"], "cpu")["t"]


def test_adapter_cache_lru_eviction_order():
    cfg, bank = _bank(2)
    loads = []

    def loader(t):
        loads.append(t)
        return _adapters(cfg, len(loads))

    cache = AdapterCache(bank, loader=loader)
    sa = cache.acquire("a"); cache.release("a")
    sb = cache.acquire("b"); cache.release("b")
    assert {sa, sb} == {0, 1}
    assert cache.acquire("a") == sa          # hit, no load
    cache.release("a")
    assert loads == ["a", "b"]
    cache.acquire("c"); cache.release("c")   # evicts b (a was touched later)
    assert "b" not in cache and "a" in cache
    assert cache.stats() == {"hits": 1, "misses": 3, "evictions": 1, "resident": 2}


def test_adapter_cache_pinned_slots_never_evicted():
    cfg, bank = _bank(1)
    cache = AdapterCache(bank, loader=lambda t: _adapters(cfg, 1))
    cache.acquire("a")  # pinned (no release)
    with pytest.raises(AdapterCacheMiss, match="pinned"):
        cache.acquire("b")
    cache.release("a")
    assert cache.acquire("b") == 0  # now evictable


def test_adapter_cache_put_matches_reference():
    """``put`` installs without the loader; on a resident tenant it
    overwrites that tenant's slot, and the JAX cache does the same."""
    cfg, bank = _bank(2)
    jcfg = jax_smoke_config(ARCH)
    jcache = JAdapterCache(JAdapterBank(jcfg, 2))
    cache = AdapterCache(bank)
    a, b = _adapters(cfg, 1), _adapters(cfg, 2)
    ja, jb = (jax.tree.map(jax.numpy.asarray, interop.adapters_to_numpy(x)) for x in (a, b))
    steps = [("a", a, ja), ("b", b, jb), ("a", b, jb), ("c", a, ja)]
    for tenant, ad, jad in steps:
        slot = cache.put(tenant, ad)
        assert slot == jcache.put(tenant, jad)
        assert torch.equal(bank.data["text"]["down"][slot], ad["text"]["down"])
        assert list(cache._lru.items()) == list(jcache._lru.items())
        assert cache.stats() == jcache.stats()
    assert cache.acquire("a") == jcache.acquire("a")  # a hit: put never calls a loader


def test_kv_pool_bytes_match_reference():
    for arch in ("llava-1.5-7b", "mamba2-130m"):
        cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
        mgr = KVSlotManager(cfg, n_slots=3, capacity=16, dtype=torch.float32, device="cpu")
        jmgr = JKVSlotManager(jcfg, n_slots=3, capacity=16, dtype=jax.numpy.float32)
        assert mgr.pool_bytes() == jmgr.pool_bytes() > 0
        assert mgr.page_bytes() == jmgr.page_bytes() == mgr.pool_bytes() // 3


def test_adapter_cache_none_tenant_and_missing_loader():
    cfg, bank = _bank(1)
    cache = AdapterCache(bank)
    assert cache.acquire(None) == -1
    cache.release(None)  # no-op
    with pytest.raises(AdapterCacheMiss, match="no loader"):
        cache.acquire("ghost")


def test_adapter_bank_set_slot_in_place_and_validates():
    cfg, bank = _bank(2)
    down_before = bank.data["text"]["down"]
    ad = _adapters(cfg, 3)
    bank.set_slot(1, ad)
    assert bank.data["text"]["down"] is down_before  # written in place
    assert torch.equal(bank.data["image"]["up"][1], ad["image"]["up"])
    assert torch.equal(bank.data["text"]["up"][0], torch.zeros_like(ad["text"]["up"]))
    with pytest.raises(IndexError):
        bank.set_slot(5, ad)
    bad = {"text": {"down": np.zeros((3, 3)), "up": np.zeros((3, 3))}, "image": ad["image"]}
    with pytest.raises(ValueError, match="shape"):
        bank.set_slot(0, bad)


def test_grouped_adapter_apply_identity_rows_exact():
    cfg, bank = _bank(2)
    bank.set_slot(0, _adapters(cfg, 1))
    x = torch.randn(5, cfg.d_model, generator=torch.Generator().manual_seed(0))
    idx = torch.tensor([0, -1, 1, -1, 0], dtype=torch.int32)
    y = grouped_adapter_apply(bank, "text", x, idx, use_pallas=True)
    assert torch.equal(y[idx < 0], x[idx < 0])
    assert torch.equal(y[2], x[2])                # slot 1 never written: identity
    assert not torch.equal(y[0], x[0])


# ---------------------------------------------------------------------------
# kv slot manager
# ---------------------------------------------------------------------------

def test_kv_slot_manager_alloc_free():
    cfg = get_smoke_config(ARCH)
    mgr = KVSlotManager(cfg, n_slots=3, capacity=16, dtype=torch.float32, device="cpu")
    assert [mgr.alloc(), mgr.alloc(), mgr.alloc()] == [0, 1, 2]
    assert mgr.alloc() is None
    mgr.free(1)
    with pytest.raises(ValueError, match="double free"):
        mgr.free(1)
    assert mgr.alloc() == 1  # deterministic lowest-first reuse
    assert mgr.n_free == 0


def test_kv_slot_manager_write_installs_page():
    cfg = get_smoke_config(ARCH)
    mgr = KVSlotManager(cfg, n_slots=2, capacity=16, dtype=torch.float32, device="cpu")
    page = {"layers": type(mgr.state["layers"])(*(torch.ones_like(t[:, :1])
                                                   for t in mgr.state["layers"]))}
    mgr.write(1, page, start_pos=5)
    assert mgr.pos[1] == 5 and mgr.pos[0] == 0
    for t in mgr.state["layers"]:
        assert bool((t[:, 1] == 1.0).all()) and bool((t[:, 0] == 0.0).all())


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

SERVE_ARGS = ["--device", "cpu", "--requests", "6", "--gen-tokens", "4", "--prefill-len", "8",
              "--slots", "3"]


def test_serve_cli_naive_and_ckpt_root(tmp_path, capsys):
    assert serve.main(SERVE_ARGS + ["--naive"]) == 0
    out = capsys.readouterr().out
    assert "synthetic tenants" in out and "token parity OK" in out
    jcfg, jbackbone, jtenants = _jax_side()
    root = str(tmp_path / "tenants")
    _jax_tenant_root(root, jcfg, jbackbone, jtenants)
    assert serve.main(SERVE_ARGS + ["--ckpt-root", root, "--tenants", "1", "--naive"]) == 0
    out = capsys.readouterr().out
    assert f"serving 1 tenants from {root}" in out and "token parity OK" in out
    assert f"[{TENANTS[0]}]" in out and f"[{TENANTS[1]}]" not in out
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(SystemExit, match="is empty"):
        serve.main(SERVE_ARGS + ["--ckpt-root", str(empty)])


def test_train_cli_checkpoints_resumes_and_serves(tmp_path, capsys):
    """Train two rounds under crashes with a snapshot a round, resume to three,
    then serve the written server checkpoint as a tenant."""
    out = tmp_path / "run"
    common = ["--device", "cpu", "--clients", "3", "--local-steps", "1",
              "--examples-per-client", "8", "--batch-size", "4", "--seq-len", "12",
              "--checkpoint-every", "1", "--crash-prob", "0.4", "--dropout-prob", "0.2",
              "--failure-seed", "3", "--out", str(out)]
    assert train.main(common + ["--rounds", "2"]) == 0
    assert sorted(os.listdir(out / "state")) == ["LATEST", "round_000001", "round_000002"]
    assert train.main(common + ["--rounds", "3", "--resume", str(out / "state")]) == 0
    text = capsys.readouterr().out
    assert "resumed at round 2" in text and "round 2:" in text
    summary = json.loads((out / "llava-1.5-7b_fednano.json").read_text())
    assert [m["round"] for m in summary["rounds"]] == [0, 1, 2]
    assert all({"dropped", "crashed"} <= set(m) for m in summary["rounds"])
    meta = json.loads((out / "ckpt" / "meta.json").read_text())
    assert meta["round_idx"] == 3 and meta["has_rng_key"] and len(meta["comm_rounds"]) >= 1
    root = tmp_path / "tenants"
    root.mkdir()
    os.rename(out / "ckpt", root / "fednano")
    assert serve.main(SERVE_ARGS + ["--ckpt-root", str(root), "--naive"]) == 0
    text = capsys.readouterr().out
    assert "serving 1 tenants" in text and "token parity OK" in text
