"""The port's paper strategies against the JAX package on smoke llava-1.5-7b:
FedNano-EF, FedAvg, FedProx, FedDPA-F, LocFT, FedAvgM and FedAdam, two rounds
each, the streaming merge, ``run_centralized``, minigpt4-7b and the training
CLI over the registry.

As in ``test_torch_training.py``, the JAX package draws the server and both
packages make the same data; the reference is the JAX engine run live on its
jnp path (``use_pallas=False``), once per strategy through
``functools.lru_cache``, and the port runs it with its kernel wrappers off
and on (on the CPU the wrappers take their plain versions). FedDPA-F's
personal adapters are random and stay, so the port's clients start from the
JAX engine's own draw (``init_clients`` over ``split(PRNGKey(0))[1]``),
handed in through a subclass of the port's ``FedDPAF``.

Tolerances relative to the reference's ∞-norm: round losses 1e-5, final
global and personal adapters ``ADAPTER_TOL`` = 1e-4 (why: the module
docstring of ``test_torch_training.py``). The server optimizers' moments are
differences of two rounds' adapters, so they are held at ``ADAPTER_TOL`` of
the adapters' own ∞-norm, the scale their error comes from.
"""
import dataclasses
import functools
import json

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import HyperParams as JHyperParams
from repro.core import run_centralized as jax_run_centralized
from repro.core import run_federated as jax_run_federated
from repro.core import server as jserver
from repro.core.comm import CommLog as JCommLog
from repro.data import make_federated_data as jax_make_data
from repro.strategies import available_strategies as jax_available_strategies
from repro.strategies import get_strategy as jax_get_strategy
from repro_torch import interop
from repro_torch.configs import get_smoke_config
from repro_torch.core import HyperParams, ServerState, run_centralized, run_federated
from repro_torch.data import make_federated_data
from repro_torch.launch import train
from repro_torch.strategies import FedDPAF, available_strategies, get_strategy
# one_torch_thread: the autouse fixture, in effect here too
from test_torch_training import (ADAPTER_TOL, DATA_KW, HP, ROUNDS, _data, _port_server,
                                 _server, assert_tree_close, one_torch_thread, rel_err)

STRATEGIES = ["fednano_ef", "fedavg", "fedprox", "feddpa_f", "locft", "fedavgm", "fedadam"]
CIDS = list(range(DATA_KW["n_clients"]))
MINIGPT = "minigpt4-7b"


def _leaf_bytes():
    return sum(a.nbytes for m in _server()[2].values() for a in m.values())


@functools.lru_cache(maxsize=None)
def _jax_personal(strategy):
    """The personal adapters the JAX engine draws for its clients (numpy)."""
    jcfg, (jtrain, _, _), _, _ = _data(False)
    _, k_clients = jax.random.split(jax.random.PRNGKey(0))
    ckeys = jax.random.split(k_clients, len(CIDS))
    clients = jax_get_strategy(strategy).init_clients(ckeys, jcfg, CIDS,
                                                      [len(jtrain[c]) for c in CIDS])
    return tuple(jax.tree.map(np.asarray, c.local_adapters) for c in clients)


@dataclasses.dataclass(frozen=True)
class _DrawnDPAF(FedDPAF):
    """The port's FedDPA-F with the JAX engine's personal adapters."""

    personal: tuple = dataclasses.field(default=(), compare=False, hash=False)

    def init_client(self, gen, cfg, cid, n_examples):
        state = super().init_client(gen, cfg, cid, n_examples)
        return dataclasses.replace(
            state, local_adapters=interop.adapters_from_numpy(self.personal[cid], "cpu"))


def _port_strategy(strategy):
    if strategy == "feddpa_f":
        return _DrawnDPAF(personal=_jax_personal(strategy))
    return strategy


@functools.lru_cache(maxsize=None)
def _jax_run(strategy, agg_chunk=None):
    jcfg, (jtrain, jeval, _), _, _ = _data(False)
    jsrv = dataclasses.replace(_server()[0], comm=JCommLog())
    return jax_run_federated(jax.random.PRNGKey(0), jcfg, jtrain, jeval, strategy=strategy,
                             rounds=ROUNDS, hp=JHyperParams(**HP), server=jsrv,
                             agg_chunk=agg_chunk)


@functools.lru_cache(maxsize=None)
def _port_run(strategy, use_pallas, agg_chunk=None):
    _, _, cfg, (train_b, eval_b, _) = _data(use_pallas)
    return run_federated(0, cfg, train_b, eval_b, strategy=_port_strategy(strategy),
                         rounds=ROUNDS, hp=HyperParams(**HP), use_pallas=use_pallas,
                         server=_port_server(cfg), agg_chunk=agg_chunk)


def assert_run_matches(got, want, what, adapters=True):
    wl = [m["mean_loss"] for m in want.round_metrics]
    gl = [m["mean_loss"] for m in got.round_metrics]
    assert [m["participants"] for m in got.round_metrics] == \
        [m["participants"] for m in want.round_metrics], what
    for g, w in zip(gl, wl):
        assert (g is None) if w is None else abs(g - w) <= 1e-5 * abs(w), (what, gl, wl)
    assert got.comm_totals == want.comm_totals, what
    assert got.client_accuracy == want.client_accuracy, what
    if adapters:
        assert_tree_close(got.server.global_adapters, want.server.global_adapters,
                          ADAPTER_TOL, f"{what} global adapters")
    assert got.server.round_idx == want.server.round_idx, what
    assert [c.rounds_participated for c in got.clients] == \
        [c.rounds_participated for c in want.clients], what


def _moment_err(got, want, scale):
    """max |got - want| over the leaves of two moment trees / ``scale``."""
    got = interop.adapters_to_numpy(got)
    return max(float(np.max(np.abs(got[m][n] - np.asarray(want[m][n])))) / scale
               for m in want for n in want[m])


# ---------------------------------------------------------------------------
# the registry and the hyperparameters
# ---------------------------------------------------------------------------

def test_registry_equals_the_reference():
    assert available_strategies() == jax_available_strategies()
    for name in available_strategies():
        mine, ref = get_strategy(name), jax_get_strategy(name)
        assert mine.name == ref.name == name
        for attr in ("wants_fisher", "dual_adapters", "aggregates"):
            assert getattr(mine, attr) == getattr(ref, attr), (name, attr)
        assert [f.name for f in dataclasses.fields(mine)] == \
            [f.name for f in dataclasses.fields(ref)], name
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref), name
        assert type(mine.server_opt()).__name__ == type(ref.server_opt()).__name__, name
    with pytest.raises(ValueError, match="unknown strategy"):
        get_strategy("fedsgd")


def test_hyperparams_equal_the_reference():
    mine, ref = dataclasses.fields(HyperParams), dataclasses.fields(JHyperParams)
    assert [(f.name, f.type, f.default) for f in mine] == \
        [(f.name, f.type, f.default) for f in ref]
    assert dataclasses.asdict(HyperParams(**HP)) == dataclasses.asdict(JHyperParams(**HP))


# ---------------------------------------------------------------------------
# the slice: two rounds of each strategy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernels"])
def test_strategy_rounds_match_reference(use_pallas, strategy):
    want, got = _jax_run(strategy), _port_run(strategy, use_pallas)
    assert got.strategy == want.strategy == strategy
    assert_run_matches(got, want, strategy)
    gl = [m["mean_loss"] for m in got.round_metrics]
    assert len(gl) == ROUNDS and gl[1] < gl[0]  # training moves the loss
    c, leaf = got.comm_totals, _leaf_bytes()
    if strategy == "locft":  # one download in round 0, never an upload
        assert c["param_down"] == 2 * leaf and c["param_up"] == c["param_up_wire"] == 0
    else:
        assert c["param_up"] == c["param_up_wire"] == c["param_down"] == 2 * ROUNDS * leaf
    assert c["fisher_up"] == (2 * ROUNDS * leaf if strategy == "fednano_ef" else 0)
    scale = float(max(np.max(np.abs(a)) for m in want.server.global_adapters.values()
                      for a in m.values()))
    if strategy == "fedavgm":
        assert _moment_err(got.server_opt_state, want.server_opt_state, scale) <= ADAPTER_TOL
    elif strategy == "fedadam":
        for k in ("m", "v"):
            ref = want.server_opt_state[k]
            s = scale if k == "m" else scale ** 2
            assert _moment_err(got.server_opt_state[k], ref, s) <= ADAPTER_TOL, k
    else:
        assert got.server_opt_state is None and want.server_opt_state is None
    for gc, wc in zip(got.clients, want.clients):
        if strategy == "feddpa_f":
            assert_tree_close(gc.local_adapters, wc.local_adapters, ADAPTER_TOL,
                              f"client {gc.cid} personal adapters")
            mu, nu, step = interop.adamw_state_to_numpy(gc.local_opt_state)
            assert int(step) == int(wc.local_opt_state.step) == HP["local_steps"]
        else:
            assert gc.local_adapters is None and wc.local_adapters is None
        if strategy == "locft":  # each client keeps and evaluates its own adapters
            assert_tree_close(gc.adapters, wc.adapters, ADAPTER_TOL, f"client {gc.cid}")
        if strategy == "fednano_ef":  # the streaming FIM of the last round
            assert_tree_close(gc.fisher, wc.fisher, ADAPTER_TOL, f"client {gc.cid} FIM")


@pytest.mark.parametrize("strategy", ["fedavg", "fednano_ef"])
@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernels"])
def test_streaming_merge_matches_reference(use_pallas, strategy):
    """agg_chunk=1 folds one upload at a time: against the JAX engine's
    streaming run, and against the port's own batch merge."""
    want, got = _jax_run(strategy, 1), _port_run(strategy, use_pallas, 1)
    assert_run_matches(got, want, f"{strategy} agg_chunk=1")
    batch = _port_run(strategy, use_pallas)
    assert_tree_close(got.server.global_adapters,
                      interop.adapters_to_numpy(batch.server.global_adapters), ADAPTER_TOL,
                      "streamed vs batch merge")


@functools.lru_cache(maxsize=None)
def _jax_centralized():
    jcfg, (jtrain, jeval, _), _, _ = _data(False)
    return jax_run_centralized(jax.random.PRNGKey(3), jcfg, jtrain, jeval, steps=3,
                               hp=JHyperParams(**HP))


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernels"])
def test_run_centralized_matches_reference(use_pallas):
    want = _jax_centralized()
    # the JAX package draws its server from split(key)[0]; the port gets it exported
    k_server, _ = jax.random.split(jax.random.PRNGKey(3))
    _, _, cfg, (train_b, eval_b, _) = _data(use_pallas)
    jsrv = jserver.init_server(k_server, jax_smoke_config(cfg.name))
    srv = ServerState(cfg=cfg, backbone=interop.backbone_from_numpy(
        cfg, jax.tree.map(np.asarray, jsrv.backbone), "cpu"),
        global_adapters=interop.adapters_from_numpy(
            jax.tree.map(np.asarray, jsrv.global_adapters), "cpu"))
    got = run_centralized(3, cfg, train_b, eval_b, steps=3, hp=HyperParams(**HP), server=srv)
    assert got.strategy == want.strategy == "centralized"
    assert rel_err(np.float32(got.round_metrics[0]["mean_loss"]),
                   np.float32(want.round_metrics[0]["mean_loss"])) <= 1e-5
    assert got.comm_totals == want.comm_totals
    assert got.comm_totals["param_up"] == got.comm_totals["param_down"] == _leaf_bytes()
    assert got.client_accuracy == want.client_accuracy
    assert got.avg_accuracy == pytest.approx(want.avg_accuracy, abs=1e-12)
    assert_tree_close(got.clients[0].adapters, want.clients[0].adapters, ADAPTER_TOL,
                      "centralized adapters")


# ---------------------------------------------------------------------------
# minigpt4-7b: the paper's second backbone
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _minigpt(use_pallas):
    """One FedNano round of smoke minigpt4-7b at its own 768-wide connector
    (``reduced`` clamps frontend_dim to 128), JAX against the port."""
    jcfg = jax_smoke_config(MINIGPT).with_(frontend_dim=768)
    cfg = get_smoke_config(MINIGPT, frontend_dim=768).with_(use_pallas=use_pallas)
    jsrv = jserver.init_server(jax.random.PRNGKey(7), jcfg)
    srv = ServerState(cfg=cfg, backbone=interop.backbone_from_numpy(
        cfg, jax.tree.map(np.asarray, jsrv.backbone), "cpu"),
        global_adapters=interop.adapters_from_numpy(
            jax.tree.map(np.asarray, jsrv.global_adapters), "cpu"))
    jtrain, jeval, _ = jax_make_data(jcfg, **DATA_KW)
    train_b, eval_b, _ = make_federated_data(cfg, device="cpu", **DATA_KW)
    want = jax_run_federated(jax.random.PRNGKey(0), jcfg, jtrain, jeval, strategy="fednano",
                             rounds=1, hp=JHyperParams(**HP), server=jsrv)
    got = run_federated(0, cfg, train_b, eval_b, strategy="fednano", rounds=1,
                        hp=HyperParams(**HP), use_pallas=use_pallas, server=srv)
    return want, got, train_b


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernels"])
def test_minigpt4_fednano_round_matches_reference(use_pallas):
    want, got, train_b = _minigpt(use_pallas)
    assert train_b[0][0].patches.shape == (4, 32, 768)  # 32 Q-Former queries of width 768
    assert got.server.backbone["connector"]["w"].shape[0] == 768
    assert_run_matches(got, want, MINIGPT)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

TRAIN_ARGS = ["--device", "cpu", "--clients", "2", "--rounds", "2", "--local-steps", "1",
              "--examples-per-client", "12", "--batch-size", "4", "--seq-len", "12"]


@pytest.mark.parametrize("strategy", list(jax_available_strategies()) + ["centralized"])
def test_train_cli_runs_each_strategy(tmp_path, capsys, strategy):
    rc = train.main(TRAIN_ARGS + ["--use-pallas", "--strategy", strategy, "--out",
                                  str(tmp_path)])
    assert rc == 0
    summary = json.loads((tmp_path / f"llava-1.5-7b_{strategy}.json").read_text())
    assert summary["strategy"] == strategy
    n_rounds = 1 if strategy == "centralized" else 2
    assert len(summary["rounds"]) == n_rounds
    assert all(np.isfinite(r["mean_loss"]) for r in summary["rounds"])
    c = summary["comm_totals"]
    assert c["param_down"] > 0
    assert (c["param_up"] == 0) == (strategy == "locft")
    assert (c["fisher_up"] > 0) == (strategy in ("fednano", "fednano_ef"))
    if strategy != "centralized":
        assert f"[{strategy}] round 1" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [["--server-opt", "fedavgm"],
                                   ["--server-opt", "fedadam", "--server-lr", "0.05"],
                                   ["--client-frac", "0.5"]],
                         ids=["fedavgm", "fedadam", "client-frac"])
def test_train_cli_server_opt_and_sampling(tmp_path, flags):
    rc = train.main(TRAIN_ARGS + ["--strategy", "fedavg", "--out", str(tmp_path)] + flags)
    assert rc == 0
    summary = json.loads((tmp_path / "llava-1.5-7b_fedavg.json").read_text())
    participants = [r["participants"] for r in summary["rounds"]]
    assert participants == ([1, 1] if "--client-frac" in flags else [2, 2])
    assert summary["comm_totals"]["param_up"] == sum(participants) * _leaf_bytes()
