"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's (``repro.checkpoint``).

Restores are strict, as in the JAX package: missing and extra keys, shape
and dtype drift raise. bfloat16 leaves go to disk as their 16-bit pattern
with the header type ``'<V2'`` (what the JAX package's ``np.savez`` writes
for ``ml_dtypes``' bfloat16) and come back bit for bit, from the port's
archives and from the JAX package's. Server checkpoints keep the ServerOpt
moments and the seed. The port reads the JAX package's adapter checkpoints
and its golden RunState (``tests/golden/run_state/``) to the bit, and a
live two-round run of each package writes a RunState with the same npz
keys, shapes, dtypes and ``meta.json`` keys.
"""
import dataclasses
import importlib.util
import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import HyperParams as JHyperParams
from repro.core import run_federated as jax_run_federated
from repro.core import server as jserver
from repro.data import make_federated_data as jax_make_data
from repro.strategies import Int8EFQuant as JInt8EFQuant
from repro_torch import interop
from repro_torch.checkpoint import (RUN_STATE_VERSION, SERVER_CHECKPOINT_VERSION,
                                    CheckpointError, CheckpointVersionError, flatten_pytree,
                                    load_adapters, load_pytree, load_run_state,
                                    load_server_checkpoint, read_run_meta,
                                    resolve_run_state_dir, save_pytree, save_run_state,
                                    save_server_checkpoint, seed_key)
from repro_torch.configs import get_smoke_config
from repro_torch.core import HyperParams, ServerState, run_federated
from repro_torch.core.client import ClientState
from repro_torch.data import make_federated_data
from repro_torch.optim import AdamWState, adamw_init
from repro_torch.strategies import FedAdamOpt, Int8EFQuant
from repro_torch.utils import tree_leaves, tree_map

from test_torch_training import one_torch_thread  # noqa: F401  (autouse fixture)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden", "run_state")
TINY = dict(n_layers=1, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64,
            frontend_dim=16)
TINY_DATA = dict(n_clients=3, examples_per_client=8, alpha=100.0, batch_size=2, seq_len=8)


def _equal_bits(a, b):
    """Two leaves equal bit for bit (bf16 by their 16-bit patterns)."""
    a = a.detach().cpu() if torch.is_tensor(a) else torch.from_numpy(np.array(a))
    b = b.detach().cpu() if torch.is_tensor(b) else torch.from_numpy(np.array(b))
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


# ---------------------------------------------------------------------------
# trees <-> npz
# ---------------------------------------------------------------------------

def test_flatten_keys_are_the_reference_paths():
    tree = {"b": {"up": torch.zeros(2), "down": torch.ones(1)}, "a": [torch.zeros(()), None],
            "opt": AdamWState(mu={"x": torch.zeros(1)}, nu={"x": torch.ones(1)},
                              step=torch.zeros((), dtype=torch.int32))}
    jtree = {"b": {"up": jnp.zeros(2), "down": jnp.ones(1)}, "a": [jnp.zeros(()), None],
             "opt": {"mu": {"x": jnp.zeros(1)}, "nu": {"x": jnp.ones(1)},
                     "step": jnp.zeros((), jnp.int32)}}
    got = flatten_pytree(tree, prefix="p")
    want = jckpt.flatten_pytree(jtree, prefix="p")
    assert list(got) == list(want)
    assert {k: (v.shape, v.dtype) for k, v in got.items()} == \
        {k: (v.shape, v.dtype) for k, v in want.items()}
    assert list(flatten_pytree(torch.zeros(3), prefix="rng_key")) == ["rng_key"]


def test_empty_tree_roundtrip(tmp_path):
    p = str(tmp_path / "empty.npz")
    save_pytree(p, {})
    assert load_pytree(p, {}) == {}


def test_scalar_leaves_roundtrip(tmp_path):
    tree = {"a": torch.tensor(1.5), "b": torch.tensor(3, dtype=torch.int32),
            "nested": {"c": torch.zeros(())}}
    p = str(tmp_path / "scalars.npz")
    save_pytree(p, tree)
    back = load_pytree(p, tree_map(torch.zeros_like, tree))
    assert float(back["a"]) == 1.5 and int(back["b"]) == 3
    assert back["b"].dtype == torch.int32 and back["nested"]["c"].shape == ()


def test_missing_key_errors(tmp_path):
    p = str(tmp_path / "t.npz")
    save_pytree(p, {"a": torch.ones(3)})
    with pytest.raises(CheckpointError, match="missing key"):
        load_pytree(p, {"a": torch.ones(3), "b": torch.ones(2)})


def test_extra_key_errors_unless_lenient(tmp_path):
    p = str(tmp_path / "t.npz")
    save_pytree(p, {"a": torch.ones(3), "b": torch.ones(2)})
    with pytest.raises(CheckpointError, match="keys not in the reference"):
        load_pytree(p, {"a": torch.ones(3)})
    back = load_pytree(p, {"a": torch.zeros(3)}, strict=False)
    assert torch.equal(back["a"], torch.ones(3))


def test_shape_mismatch_errors(tmp_path):
    p = str(tmp_path / "t.npz")
    save_pytree(p, {"a": torch.ones((2, 3))})
    with pytest.raises(CheckpointError, match="shape mismatch"):
        load_pytree(p, {"a": torch.ones((3, 2))})


@pytest.mark.parametrize("saved,ref", [(torch.float32, torch.float16),
                                       (torch.float32, torch.bfloat16),
                                       (torch.bfloat16, torch.float32),
                                       (torch.int32, torch.int64)],
                         ids=["f32->f16", "f32->bf16", "bf16->f32", "i32->i64"])
def test_dtype_mismatch_errors_not_casts(tmp_path, saved, ref):
    p = str(tmp_path / "t.npz")
    save_pytree(p, {"a": torch.ones(4, dtype=saved)})
    with pytest.raises(CheckpointError, match="dtype mismatch"):
        load_pytree(p, {"a": torch.ones(4, dtype=ref)})


def _bf16_tree():
    g = torch.Generator().manual_seed(0)
    w = torch.randn((5, 7), generator=g).to(torch.bfloat16)
    w[0, :3] = torch.tensor([float("inf"), float("nan"), -0.0])
    return {"w": w, "s": torch.randn((), generator=g).to(torch.bfloat16)}


def test_bf16_roundtrip_bit_for_bit(tmp_path):
    tree = _bf16_tree()
    p = str(tmp_path / "bf16.npz")
    save_pytree(p, tree)
    with np.load(p, allow_pickle=False) as data:
        assert data["w"].dtype.kind == "V" and data["w"].dtype.itemsize == 2
    back = load_pytree(p, tree_map(torch.zeros_like, tree))
    assert all(_equal_bits(back[k], tree[k]) and back[k].dtype == torch.bfloat16 for k in tree)


def test_bf16_archive_is_the_reference_archive(tmp_path):
    """The port's archive of a bf16 tensor is byte for byte the JAX package's
    archive of the same bit patterns (``'<V2'`` in the header)."""
    tree = _bf16_tree()
    jtree = {k: v.view(torch.int16).numpy().view(jnp.bfloat16) for k, v in tree.items()}
    save_pytree(str(tmp_path / "port.npz"), tree)
    jckpt.save_pytree(str(tmp_path / "jax.npz"), jtree)
    with zipfile.ZipFile(tmp_path / "port.npz") as a, zipfile.ZipFile(tmp_path / "jax.npz") as b:
        assert a.namelist() == b.namelist()
        for name in a.namelist():
            assert a.read(name) == b.read(name), name


def test_jax_written_bf16_read_bit_for_bit(tmp_path):
    """The JAX package's own loader refuses this archive (its strict check
    sees |V2 against bfloat16); the port views the pattern back."""
    rng = np.random.default_rng(3)
    jtree = {"a": {"w": jnp.asarray(rng.standard_normal((4, 6)), jnp.bfloat16)},
             "b": jnp.asarray(rng.standard_normal((3,)), jnp.float32)}
    p = str(tmp_path / "jax.npz")
    jckpt.save_pytree(p, jtree)
    with pytest.raises(jckpt.CheckpointError, match="dtype mismatch"):
        jckpt.load_pytree(p, jtree)  # the reference-side finding (ROADMAP §3)
    ref = {"a": {"w": torch.zeros((4, 6), dtype=torch.bfloat16)}, "b": torch.zeros(3)}
    back = load_pytree(p, ref)
    want = np.asarray(jtree["a"]["w"]).view(np.uint16).astype(np.int32)
    assert np.array_equal(back["a"]["w"].view(torch.int16).numpy().view(np.uint16), want)
    assert np.array_equal(back["b"].numpy(), np.asarray(jtree["b"]))


# ---------------------------------------------------------------------------
# server checkpoints and adapter checkpoints
# ---------------------------------------------------------------------------

def _tiny_cfgs():
    return jax_smoke_config("llava-1.5-7b").with_(**TINY), \
        get_smoke_config("llava-1.5-7b").with_(**TINY)


@pytest.fixture(scope="module")
def tiny_servers():
    jcfg, cfg = _tiny_cfgs()
    jsrv = jserver.init_server(jax.random.PRNGKey(0), jcfg)
    srv = ServerState(cfg=cfg, backbone=interop.backbone_from_numpy(
        cfg, jax.tree.map(np.asarray, jsrv.backbone), "cpu"),
        global_adapters=interop.adapters_from_numpy(jax.tree.map(np.asarray,
                                                                 jsrv.global_adapters), "cpu"))
    return jsrv, srv


def test_server_checkpoint_keeps_moments_and_seed(tmp_path, tiny_servers):
    _, srv = tiny_servers
    opt = FedAdamOpt()
    moments = tree_map(lambda x: torch.full_like(x, 0.5), opt.init(srv.global_adapters))
    d = str(tmp_path / "ckpt")
    save_server_checkpoint(d, srv, round_idx=3, server_opt_state=moments, seed=42)
    blank = dataclasses.replace(srv, backbone=tree_map(torch.zeros_like, srv.backbone),
                                global_adapters=tree_map(torch.zeros_like, srv.global_adapters))
    restored, meta = load_server_checkpoint(d, blank,
                                            server_opt_state=opt.init(srv.global_adapters))
    assert meta["round_idx"] == 3 and meta["seed"] == 42
    assert np.array_equal(meta["rng_key"], seed_key(42))
    assert all(_equal_bits(a, b) for a, b in zip(tree_leaves(meta["server_opt_state"]),
                                                 tree_leaves(moments)))
    assert all(_equal_bits(a, b) for a, b in zip(tree_leaves(restored.backbone),
                                                 tree_leaves(srv.backbone)))
    assert all(_equal_bits(a, b) for a, b in zip(tree_leaves(restored.global_adapters),
                                                 tree_leaves(srv.global_adapters)))


def test_server_checkpoint_refuses_to_drop_moments(tmp_path, tiny_servers):
    _, srv = tiny_servers
    d = str(tmp_path / "ckpt")
    save_server_checkpoint(d, srv, round_idx=1,
                           server_opt_state={"m": tree_map(torch.zeros_like,
                                                           srv.global_adapters)})
    with pytest.raises(CheckpointError, match="ServerOpt moments"):
        load_server_checkpoint(d, srv)


def test_server_checkpoint_version_mismatch(tmp_path, tiny_servers):
    _, srv = tiny_servers
    d = str(tmp_path / "ckpt")
    save_server_checkpoint(d, srv, round_idx=1)
    meta_path = os.path.join(d, "meta.json")
    meta = json.loads(open(meta_path).read())
    meta["format_version"] = SERVER_CHECKPOINT_VERSION - 1
    open(meta_path, "w").write(json.dumps(meta))
    with pytest.raises(CheckpointVersionError, match="format_version"):
        load_server_checkpoint(d, srv)


def test_seed_key_is_never_a_jax_key():
    assert seed_key(0).dtype == np.uint32 and seed_key(0).shape == (2,)
    for s in (0, 1, 7, 2**31):
        assert not np.array_equal(seed_key(s), np.asarray(jax.random.PRNGKey(s)))
    with pytest.raises(ValueError):
        seed_key(-1)


def test_load_adapters_reads_jax_server_checkpoints_and_bare_npz(tmp_path, tiny_servers):
    jsrv, srv = tiny_servers
    d = str(tmp_path / "srv")
    jckpt.save_server_checkpoint(d, jsrv, round_idx=2, rng_key=jax.random.PRNGKey(1))
    bare = str(tmp_path / "tenant.npz")
    jckpt.save_pytree(bare, jsrv.global_adapters)
    ref = tree_map(torch.zeros_like, srv.global_adapters)
    for path in (d, bare):
        want = jckpt.load_adapters(path, jsrv.global_adapters)
        got = load_adapters(path, ref)
        assert all(_equal_bits(g, np.asarray(w)) for g, w in zip(
            tree_leaves(got), tree_leaves(interop.adapters_from_numpy(
                jax.tree.map(np.asarray, want), "cpu"))))
    with pytest.raises(CheckpointError, match="not a server checkpoint"):
        load_adapters(str(tmp_path), ref)
    with pytest.raises(CheckpointError, match="no adapter checkpoint"):
        load_adapters(str(tmp_path / "ghost.npz"), ref)


# ---------------------------------------------------------------------------
# RunState: the golden fixture, torn writes, versions, LATEST
# ---------------------------------------------------------------------------

def _golden_build():
    spec = importlib.util.spec_from_file_location(
        "gen_runstate_golden",
        os.path.join(os.path.dirname(__file__), "..", "scripts", "gen_runstate_golden.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return gen.build()


def _golden_refs():
    """The port's reference structures for the golden fixture: adapters
    {"layer0": {"A" (2, 3), "B" (3, 2)}}, two clients (the first with a
    Fisher), one transform."""
    adp = {"layer0": {"A": torch.zeros((2, 3)), "B": torch.zeros((3, 2))}}
    clients = [ClientState(cid=c, adapters=tree_map(torch.zeros_like, adp),
                           opt_state=adamw_init(adp), n_examples=0) for c in (0, 1)]
    return dict(clients_ref=clients, global_ref=adp,
                transform_templates=[tree_map(torch.zeros_like, adp)])


def test_golden_run_state_reads_as_the_reference_reads_it():
    want = _golden_build()
    jrefs = dict(
        clients_ref=[dataclasses.replace(c, adapters=jax.tree.map(jnp.zeros_like, c.adapters),
                                         opt_state=jax.tree.map(jnp.zeros_like, c.opt_state),
                                         fisher=None) for c in want.clients],
        global_ref=jax.tree.map(jnp.zeros_like, want.global_adapters),
        transform_templates=[jax.tree.map(jnp.zeros_like, want.global_adapters)])
    jrs = jckpt.load_run_state(GOLDEN_DIR, **jrefs)
    rs = load_run_state(GOLDEN_DIR, **_golden_refs())

    def same(got, ref):
        gl, rl = tree_leaves(got), jax.tree.leaves(ref)
        return len(gl) == len(rl) and all(_equal_bits(g, np.asarray(r)) for g, r in zip(gl, rl))

    assert same(rs.global_adapters, jrs.global_adapters)
    assert np.array_equal(rs.rng_key, np.asarray(jrs.rng_key))
    for got, ref in zip(rs.clients, jrs.clients):
        assert (got.cid, got.n_examples, got.rounds_participated) == \
            (ref.cid, ref.n_examples, ref.rounds_participated)
        assert same(got.adapters, ref.adapters)
        assert same([got.opt_state.mu, got.opt_state.nu, got.opt_state.step],
                    [ref.opt_state.mu, ref.opt_state.nu, ref.opt_state.step])
        assert (got.fisher is None) == (ref.fisher is None)
        if ref.fisher is not None:
            assert same(got.fisher, ref.fisher)
    assert rs.tstates[1] == [None] and same(rs.tstates[0][0], jrs.tstates[0][0])
    for field in ("engine", "strategy", "round_idx", "server_round_idx", "round_metrics",
                  "comm_rounds", "meta_extra"):
        assert getattr(rs, field) == getattr(jrs, field), field
    assert read_run_meta(GOLDEN_DIR) == jckpt.read_run_meta(GOLDEN_DIR)


def _saved_golden(tmp_path):
    rs = load_run_state(GOLDEN_DIR, **_golden_refs())
    d = str(tmp_path / "rs")
    save_run_state(d, rs)
    return d


def test_run_state_resaved_reads_back_in_both_packages(tmp_path):
    """The port's save of the golden state: the JAX loader reads it, and its
    npz holds the fixture's entries, bit for bit."""
    d = _saved_golden(tmp_path)
    with np.load(os.path.join(d, "run_state.npz")) as a, \
            np.load(os.path.join(GOLDEN_DIR, "run_state.npz")) as b:
        assert set(a.files) == set(b.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert read_run_meta(d) == read_run_meta(GOLDEN_DIR)


def _edit_meta(d, **kw):
    meta_path = os.path.join(d, "meta.json")
    meta = json.loads(open(meta_path).read())
    meta.update(kw)
    open(meta_path, "w").write(json.dumps(meta))


def test_run_state_torn_write_detected(tmp_path):
    d = _saved_golden(tmp_path)
    _edit_meta(d, nonce="sequential:99:99:0", round_idx=99)
    with pytest.raises(CheckpointError, match="torn checkpoint"):
        load_run_state(d, **_golden_refs())


def test_run_state_version_mismatch(tmp_path):
    d = _saved_golden(tmp_path)
    _edit_meta(d, format_version=RUN_STATE_VERSION + 1)
    with pytest.raises(CheckpointVersionError):
        read_run_meta(d)
    with pytest.raises(CheckpointVersionError):
        load_run_state(d, **_golden_refs())


def test_run_state_client_count_mismatch(tmp_path):
    d = _saved_golden(tmp_path)
    refs = _golden_refs()
    refs["clients_ref"] = refs["clients_ref"][:1]
    with pytest.raises(CheckpointError, match="holds 2 clients"):
        load_run_state(d, **refs)


def test_resolve_latest(tmp_path):
    root = tmp_path / "root"
    d = str(root / "round_000002")
    save_run_state(d, load_run_state(GOLDEN_DIR, **_golden_refs()))
    with pytest.raises(CheckpointError, match="neither meta.json nor LATEST"):
        resolve_run_state_dir(str(root))
    (root / "LATEST").write_text("round_000002")
    assert resolve_run_state_dir(str(root)) == d
    assert resolve_run_state_dir(d) == d
    (root / "LATEST").write_text("round_000009")
    with pytest.raises(CheckpointError, match="no meta.json"):
        resolve_run_state_dir(str(root))


# ---------------------------------------------------------------------------
# layout: a live JAX run and the port's run of the same config
# ---------------------------------------------------------------------------

LAYOUT_CASES = {
    "fednano_int8_ef": dict(strategy="fednano", transforms="int8"),
    "fedadam": dict(strategy="fedadam", transforms=None),
}


def _layout(d):
    d = resolve_run_state_dir(d)
    with np.load(os.path.join(d, "run_state.npz"), allow_pickle=False) as data:
        arrays = {k: (data[k].shape, data[k].dtype.str) for k in data.files}
    return arrays, read_run_meta(d)


@pytest.mark.parametrize("case", list(LAYOUT_CASES))
def test_run_state_layout_matches_a_live_reference_run(tmp_path, case):
    strategy, transforms = LAYOUT_CASES[case]["strategy"], LAYOUT_CASES[case]["transforms"]
    jcfg, cfg = _tiny_cfgs()
    hp = dict(lr=5e-3, local_steps=1, fisher_batches=1)
    jtrain, jeval, _ = jax_make_data(jcfg, **TINY_DATA)
    jax_run_federated(jax.random.PRNGKey(0), jcfg, jtrain, jeval, strategy=strategy, rounds=2,
                      hp=JHyperParams(**hp), final_eval=False, checkpoint_dir=str(tmp_path / "j"),
                      transforms=(JInt8EFQuant(),) if transforms else None)
    train, evald, _ = make_federated_data(cfg, device="cpu", **TINY_DATA)
    run_federated(0, cfg, train, evald, strategy=strategy, rounds=2, hp=HyperParams(**hp),
                  final_eval=False, checkpoint_dir=str(tmp_path / "p"), device="cpu",
                  transforms=(Int8EFQuant(),) if transforms else None)
    (want, jmeta), (got, meta) = _layout(str(tmp_path / "j")), _layout(str(tmp_path / "p"))
    assert set(got) == set(want)
    assert got == want  # shapes and dtypes, entry by entry
    assert any(k.startswith("sopt/m/") for k in got) == (strategy == "fedadam")
    assert any(k.startswith("tstate/") for k in got) == bool(transforms)
    assert set(meta) == set(jmeta)
    for k in ("format_version", "nonce", "engine", "strategy", "round_idx", "server_round_idx",
              "n_clients", "n_transforms", "tstate_present", "has_server_opt_state",
              "cfg_name", "hp", "strategy_meta", "transforms", "failure_model", "buffered"):
        assert meta[k] == jmeta[k], k
    assert [sorted(c) for c in meta["clients"]] == [sorted(c) for c in jmeta["clients"]]
    assert [{k: c[k] for k in c if k != "rounds_participated"} for c in meta["clients"]] == \
        [{k: c[k] for k in c if k != "rounds_participated"} for c in jmeta["clients"]]
    assert meta["comm_rounds"] == jmeta["comm_rounds"]
