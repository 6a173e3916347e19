"""The port's FedNano training round against the JAX package on smoke
llava-1.5-7b and smoke mamba2-130m.

The JAX package draws the server (backbone and global adapters); both sides
get it as numpy through ``repro_torch.interop``. Data comes from the two
packages' own ``make_federated_data``, which must agree element for element.
The reference is the JAX package run live, its Pallas kernels in interpret
mode where ``use_pallas`` asks for them, never the stale goldens under
``tests/golden``. Everything runs in f32 on the CPU, where the port's kernel
wrappers take their plain versions. The JAX package cannot differentiate
its SSD kernel (``pallas_call`` has no transpose rule), so on mamba2 the
reference always runs its jnp path (``use_pallas=False``), while the port
runs with its kernels off and on; mamba2's 40-token rows cross its 32-step
SSD chunk.

Tolerances are relative to the reference's ∞-norm: 1e-6 for the loss
functions and one AdamW step, 1e-5 for the model loss, its adapter gradient
and the Fisher pass. The final global adapters after two rounds are held at
``ADAPTER_TOL`` = 1e-4: AdamW turns a rounding-level difference in a gradient
element near zero into a visible change of its update (the step is
g / (|g| + 1e-8)), and the JAX package differs from itself by 3.1e-5 between
its Pallas and jnp paths on the same run; the port differs from it by at
most 3.8e-5.
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
from repro.core import client as jclient
from repro.core.comm import CommLog as JCommLog
from repro.core import fisher as jfisher
from repro.core import run_federated as jax_run_federated
from repro.core import server as jserver
from repro.data import make_federated_data as jax_make_data
from repro.models import layers as jlayers
from repro.optim import adamw as jadamw
from repro.strategies import available_strategies
from repro_torch import interop
from repro_torch.configs import get_smoke_config
from repro_torch.core import HyperParams, ServerState, run_federated
from repro_torch.core import adapters as nano
from repro_torch.core import client as client_lib
from repro_torch.core.fisher import fisher_pass
from repro_torch.data import make_federated_data
from repro_torch.launch import train
from repro_torch.models import layers
from repro_torch.optim import adamw
from repro_torch.strategies import base as strategies_base

ARCH = "llava-1.5-7b"
ARCHS = [ARCH, "mamba2-130m"]
DATA_KW = dict(n_clients=2, examples_per_client=16, batch_size=4, seq_len=16, seed=0)
DATA_KW_BY_ARCH = {ARCH: DATA_KW, "mamba2-130m": dict(DATA_KW, seq_len=40),
                   "minigpt4-7b": DATA_KW}
HP = dict(lr=5e-3, local_steps=2, fisher_batches=2)
ROUNDS = 2
ADAPTER_TOL = 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test's torch ops on one thread: smoke-size tensors gain nothing
    from more, and under pytest-xdist the workers share the cores, where a
    thread pool per op waits on cores other workers hold (a port run took
    100x its time alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_err(got, want):
    g = got.float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.max(np.abs(g - w))) / max(float(np.max(np.abs(w))), 1e-30)


def assert_tree_close(got, want, tol, what=""):
    got = interop.adapters_to_numpy(got)
    want = jax.tree.map(np.asarray, want)
    assert sorted(got) == sorted(want), what
    for m in want:
        for n in want[m]:
            e = rel_err(got[m][n], want[m][n])
            assert e <= tol, f"{what} {m}.{n}: max |err| / ‖ref‖∞ = {e:.3e} > {tol:.0e}"


def _jax_pallas(arch, use_pallas):
    """Whether the reference runs its Pallas kernels: never on mamba2, whose
    SSD kernel the JAX package cannot differentiate."""
    return use_pallas and arch == ARCH


@functools.lru_cache(maxsize=None)
def _server(arch=ARCH):
    """The JAX-initialized server and its numpy export."""
    jsrv = jserver.init_server(jax.random.PRNGKey(7), jax_smoke_config(arch))
    return jsrv, jax.tree.map(np.asarray, jsrv.backbone), jax.tree.map(np.asarray,
                                                                       jsrv.global_adapters)


def _port_server(cfg):
    _, backbone, adapters = _server(cfg.name)
    return ServerState(cfg=cfg, backbone=interop.backbone_from_numpy(cfg, backbone, "cpu"),
                       global_adapters=interop.adapters_from_numpy(adapters, "cpu"))


@functools.lru_cache(maxsize=None)
def _data(use_pallas, arch=ARCH):
    jcfg = jax_smoke_config(arch).with_(use_pallas=_jax_pallas(arch, use_pallas))
    cfg = get_smoke_config(arch).with_(use_pallas=use_pallas)
    kw = DATA_KW_BY_ARCH[arch]
    return jcfg, jax_make_data(jcfg, **kw), cfg, make_federated_data(cfg, device="cpu", **kw)


def _trained_adapters(arch=ARCH):
    """Non-identity adapters (up ≠ 0), so the down gradients are not zero."""
    rng = np.random.default_rng(5)
    _, _, adapters = _server(arch)
    return {m: {"down": a["down"], "up": (rng.standard_normal(a["up"].shape) * 0.05)
                .astype(np.float32)} for m, a in adapters.items()}


# ---------------------------------------------------------------------------
# data, losses, one step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS + ["minigpt4-7b"])
def test_federated_data_matches_reference(arch):
    _, (jtrain, jeval, _), _, (train_b, eval_b, _) = _data(False, arch)
    for want_split, got_split in ((jtrain, train_b), (jeval, eval_b)):
        assert sorted(got_split) == sorted(want_split)
        for cid in want_split:
            assert len(got_split[cid]) == len(want_split[cid])
            for got, want in zip(got_split[cid], want_split[cid]):
                for field in ("tokens", "labels", "mask", "patches"):
                    g, w = getattr(got, field), getattr(want, field)
                    if w is None:  # text-only: no image stream
                        assert g is None, field
                        continue
                    np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if arch == ARCH:
        assert train_b[0][0].patches.shape == (4, 64, 128)
    elif arch == "minigpt4-7b":  # 32 Q-Former queries; reduced() clamps the width to 128
        assert train_b[0][0].patches.shape == (4, 32, 128)
    else:
        assert train_b[0][0].patches is None and train_b[0][0].tokens.shape == (4, 40)


def test_lm_loss_and_token_accuracy():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 7, 64)) * 3).astype(np.float32)
    logits[0, 1] = logits[0, 1].max() + 1.0  # ties in argmax
    labels = rng.integers(0, 64, (2, 7)).astype(np.int32)
    labels[1, :3] = logits[1, :3].argmax(-1)  # some right answers
    mask = (rng.random((2, 7)) < 0.6).astype(np.float32)
    args = (logits, labels, mask)
    jargs = tuple(jnp.asarray(a) for a in args)
    targs = (torch.from_numpy(logits), torch.from_numpy(labels).long(), torch.from_numpy(mask))
    for name in ("lm_loss", "token_accuracy"):
        want = getattr(jlayers, name)(*jargs)
        got = getattr(layers, name)(*targs)
        assert rel_err(got, want) <= 1e-6, name
    assert float(layers.token_accuracy(*targs)) > 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernels"])
def test_loss_and_adapter_grad_match_reference(use_pallas, arch):
    jcfg, (jtrain, _, _), cfg, (train_b, _, _) = _data(use_pallas, arch)
    jsrv, _, _ = _server(arch)
    ad = _trained_adapters(arch)
    jloss, jgrads = jax.value_and_grad(
        lambda a: jnano.fednano_loss(jcfg, jsrv.backbone, a, jtrain[0][0])[0])(
        jax.tree.map(jnp.asarray, ad))
    srv = _port_server(cfg)
    loss, _, grads = client_lib.value_and_grad(
        lambda a: nano.fednano_loss(cfg, srv.backbone, a, train_b[0][0]),
        interop.adapters_from_numpy(ad, "cpu"))
    assert rel_err(loss, jloss) <= 1e-5
    assert_tree_close(grads, jgrads, 1e-5, "adapter grad")
    assert all(not t.requires_grad for lp in srv.backbone["layers"] for d in lp.values()
               for t in d.values())


def test_adamw_clipped_step_matches_reference():
    rng = np.random.default_rng(1)
    shapes = {"text": {"down": (16, 4), "up": (4, 16)}, "image": {"down": (16, 4)}}
    draw = lambda s=1.0: {m: {n: (rng.standard_normal(sh) * s).astype(np.float32)
                              for n, sh in d.items()} for m, d in shapes.items()}
    params, grads, mu = draw(), draw(3.0), draw(0.1)
    nu = jax.tree.map(np.abs, draw(0.01))
    jstate = jadamw.AdamWState(mu=mu, nu=nu, step=np.int32(3))
    kw = dict(lr=5e-3, weight_decay=0.01, grad_clip=1.0)  # the clip is active
    jp, js = jadamw.adamw_update(jax.tree.map(jnp.asarray, grads), jstate,
                                 jax.tree.map(jnp.asarray, params), **kw)
    state = interop.adamw_state_from_numpy(jstate, "cpu")
    tp, ts = adamw.adamw_update(interop.adapters_from_numpy(grads, "cpu"), state,
                                interop.adapters_from_numpy(params, "cpu"), **kw)
    assert_tree_close(tp, jp, 1e-6, "params")
    assert_tree_close(ts.mu, js.mu, 1e-6, "mu")
    assert_tree_close(ts.nu, js.nu, 1e-6, "nu")
    mu_np, nu_np, step = interop.adamw_state_to_numpy(ts)
    assert int(step) == int(js.step) == 4


def test_fisher_pass_matches_reference():
    jcfg, (jtrain, _, _), cfg, (train_b, _, _) = _data(False)
    jsrv, _, _ = _server()
    ad = _trained_adapters()
    gfn = jclient.make_fisher_grad(jcfg)
    want = jfisher.fisher_pass(lambda a, b: gfn(jsrv.backbone, a, b),
                               jax.tree.map(jnp.asarray, ad), jtrain[1][:2])
    srv = _port_server(cfg)
    got = fisher_pass(lambda a, b: client_lib.fisher_grad(cfg, srv.backbone, a, b),
                      interop.adapters_from_numpy(ad, "cpu"), train_b[1][:2])
    assert_tree_close(got, want, 1e-5, "fisher")


# ---------------------------------------------------------------------------
# the slice: two FedNano rounds
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_run(arch, jax_pallas, agg_chunk):
    jcfg, (jtrain, jeval, _), _, _ = _data(jax_pallas, arch)
    jsrv = dataclasses.replace(_server(arch)[0], comm=JCommLog())  # the JAX engine appends
    return jax_run_federated(jax.random.PRNGKey(0), jcfg, jtrain, jeval, strategy="fednano",
                             rounds=ROUNDS, hp=JHyperParams(**HP), use_pallas=jax_pallas,
                             server=jsrv, agg_chunk=agg_chunk)


@functools.lru_cache(maxsize=None)
def _runs(use_pallas, agg_chunk, arch=ARCH):
    want = _jax_run(arch, _jax_pallas(arch, use_pallas), agg_chunk)
    _, _, cfg, (train_b, eval_b, _) = _data(use_pallas, arch)
    got = run_federated(0, cfg, train_b, eval_b, strategy="fednano", rounds=ROUNDS,
                        hp=HyperParams(**HP), use_pallas=use_pallas, server=_port_server(cfg),
                        agg_chunk=agg_chunk)
    return want, got


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("agg_chunk", [None, 1], ids=["merge", "fold"])
@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernels"])
def test_fednano_rounds_match_reference(use_pallas, agg_chunk, arch):
    want, got = _runs(use_pallas, agg_chunk, arch)
    wl = [m["mean_loss"] for m in want.round_metrics]
    gl = [m["mean_loss"] for m in got.round_metrics]
    assert len(gl) == ROUNDS and [m["participants"] for m in got.round_metrics] == [2, 2]
    for g, w in zip(gl, wl):
        assert abs(g - w) <= 1e-5 * abs(w), (gl, wl)
    assert gl[1] < gl[0]  # training moves the loss
    assert got.comm_totals == want.comm_totals
    leaf_bytes = sum(a.nbytes for m in _server(arch)[2].values() for a in m.values())
    assert got.comm_totals["param_up"] == got.comm_totals["fisher_up"] == 2 * ROUNDS * leaf_bytes
    assert got.client_accuracy == want.client_accuracy
    assert_tree_close(got.server.global_adapters, want.server.global_adapters, ADAPTER_TOL,
                      "global adapters")
    assert got.server.round_idx == ROUNDS
    assert [c.rounds_participated for c in got.clients] == [ROUNDS, ROUNDS]


@pytest.mark.parametrize("arch", ARCHS)
def test_streaming_and_batch_merge_agree(arch):
    """agg_chunk=1 folds one client at a time and scales the eps floor by the
    total weight; after two rounds it lands where the batch merge does, to f32
    summation order through AdamW (the batch merge normalizes the weights first)."""
    for use_pallas in (False, True):
        _, merged = _runs(use_pallas, None, arch)
        _, folded = _runs(use_pallas, 1, arch)
        assert_tree_close(folded.server.global_adapters,
                          interop.adapters_to_numpy(merged.server.global_adapters),
                          ADAPTER_TOL, f"use_pallas={use_pallas}")


def test_sharded_engine_runs_through_the_cli(tmp_path, capsys):
    """``--engine sharded`` on the CPU: one logical shard by default, the
    round loop and summary as the other engines' (its numbers:
    test_torch_sharded.py)."""
    args = ["--device", "cpu", "--engine", "sharded", "--clients", "2", "--rounds", "2",
            "--local-steps", "2", "--examples-per-client", "8", "--alpha", "100",
            "--batch-size", "4", "--seq-len", "16", "--out", str(tmp_path)]
    assert train.main(args) == 0
    out = capsys.readouterr().out
    assert "round 1" in out and "avg client accuracy" in out
    summary = json.loads((tmp_path / "llava-1.5-7b_fednano.json").read_text())
    assert [m["participants"] for m in summary["rounds"]] == [2, 2]


def test_strategy_names_cover_the_reference():
    """The port's registry is the JAX package's."""
    assert strategies_base.available_strategies() == available_strategies()
    assert set(strategies_base._REGISTRY) == set(available_strategies())
    assert strategies_base.get_strategy("fednano").wants_fisher == "dedicated"


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_runs_on_cpu(tmp_path, capsys, arch):
    rc = train.main(["--arch", arch, "--device", "cpu", "--use-pallas", "--clients", "2",
                     "--rounds", "1", "--local-steps", "1", "--examples-per-client", "12",
                     "--batch-size", "4", "--seq-len", "40" if arch != ARCH else "12",
                     "--agg-chunk", "1", "--out", str(tmp_path)])
    assert rc == 0
    summary = json.loads((tmp_path / f"{arch}_fednano.json").read_text())
    assert len(summary["rounds"]) == 1 and np.isfinite(summary["rounds"][0]["mean_loss"])
    assert summary["comm_totals"]["param_up"] == summary["comm_totals"]["fisher_up"] > 0
    assert "round 0" in capsys.readouterr().out
