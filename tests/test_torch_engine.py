"""The port's vmap round engine against the JAX package's, and against the
port's own sequential engine.

The vmap engine folds a cohort's clients into one batch through the frozen
backbone (``client.local_update_many``). Against the JAX engine (``vmap``
over clients of ``lax.scan`` over steps), on ``test_torch_checkpoint``'s
``TINY`` llava config with 3 clients, the JAX-drawn server exported through
``repro_torch.interop``, both packages' data: the six paper strategies, a
cohort drawn by the JAX ``FixedSizeSampler`` (replayed in the port, whose
samplers draw other cohorts), and ``agg_chunk`` 2 and 3. Against the port's
sequential engine: all eight strategies on ``TINY`` and every family's
smoke config (dense with its window, qwen2-vl's M-RoPE, the MoE family with
capacity drops, ssm, hybrid, audio). Then one test for each place where
folding could mix clients: the AdamW clip and step, the MoE routing groups,
the loss mean, FedDPA-F's warmup state; and each client's gradient against
its own.

Tolerances relative to the reference's ∞-norm: round losses 1e-5, adapters
``test_torch_training.ADAPTER_TOL`` (1e-4; why: that module's docstring);
comm totals, participants and counts exactly. The vmap engine against the
sequential one on the same device runs the same arithmetic but for batched
products, held at the same bounds.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import HyperParams as JHyperParams
from repro.core import run_federated as jax_run_federated
from repro.core import server as jserver
from repro.core.comm import CommLog as JCommLog
from repro.data import make_federated_data as jax_make_data
from repro.strategies import FixedSizeSampler as JFixedSizeSampler
from repro.strategies import get_strategy as jax_get_strategy
from repro_torch import interop
from repro_torch.checkpoint import CheckpointError
from repro_torch.configs import get_smoke_config
from repro_torch.core import HyperParams, ServerState, init_server, run_federated
from repro_torch.core import client as client_lib
from repro_torch.data import make_federated_data
from repro_torch.launch import train
from repro_torch.models import layers
from repro_torch.models import moe
from repro_torch.optim import adamw_init, adamw_update, adamw_update_many
from repro_torch.strategies import ClientSampler, FedDPAF, available_strategies, get_strategy
from repro_torch.utils import tree_leaves, tree_map, tree_stack, tree_unstack

from test_torch_checkpoint import TINY, TINY_DATA
from test_torch_resume import assert_equivalent
from test_torch_training import ADAPTER_TOL, assert_tree_close, one_torch_thread  # noqa: F401

PAPER_STRATEGIES = ("fednano", "fednano_ef", "fedavg", "fedprox", "feddpa_f", "locft")
ROUNDS = 2
HP = dict(lr=5e-3, local_steps=2, fisher_batches=2)
CIDS = list(range(TINY_DATA["n_clients"]))


@functools.lru_cache(maxsize=None)
def _tiny():
    """The JAX-drawn tiny server (and its numpy export) and both packages' data."""
    jcfg = jax_smoke_config("llava-1.5-7b").with_(**TINY)
    cfg = get_smoke_config("llava-1.5-7b").with_(**TINY)
    jsrv = jserver.init_server(jax.random.PRNGKey(3), jcfg)
    return (jcfg, jsrv, jax_make_data(jcfg, **TINY_DATA), cfg,
            jax.tree.map(np.asarray, jsrv.backbone), jax.tree.map(np.asarray,
                                                                  jsrv.global_adapters),
            make_federated_data(cfg, device="cpu", **TINY_DATA))


def _port_server():
    _, _, _, cfg, backbone, adapters, _ = _tiny()
    return ServerState(cfg=cfg, backbone=interop.backbone_from_numpy(cfg, backbone, "cpu"),
                       global_adapters=interop.adapters_from_numpy(adapters, "cpu"))


@functools.lru_cache(maxsize=None)
def _jax_personal():
    """The personal adapters the JAX engine draws for its clients (numpy)."""
    jcfg, _, (jtrain, _, _), *_ = _tiny()
    _, k_clients = jax.random.split(jax.random.PRNGKey(0))
    clients = jax_get_strategy("feddpa_f").init_clients(
        jax.random.split(k_clients, len(CIDS)), jcfg, CIDS, [len(jtrain[c]) for c in CIDS])
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
    return _DrawnDPAF(personal=_jax_personal()) if strategy == "feddpa_f" else strategy


@dataclasses.dataclass(frozen=True)
class _Replay(ClientSampler):
    """The cohorts a JAX sampler draws, replayed in the port."""

    jax_sampler: object = None

    def select(self, round_idx, cids):
        return list(self.jax_sampler.select(round_idx, cids))


@functools.lru_cache(maxsize=None)
def _jax_run(strategy, agg_chunk=None, sampler=None, rounds=ROUNDS):
    jcfg, jsrv, (jtrain, jeval, _), *_ = _tiny()
    return jax_run_federated(jax.random.PRNGKey(0), jcfg, jtrain, jeval, strategy=strategy,
                             rounds=rounds, hp=JHyperParams(**HP),
                             server=dataclasses.replace(jsrv, comm=JCommLog()),
                             engine="vmap", agg_chunk=agg_chunk, sampler=sampler)


def _port_run(strategy, engine="vmap", hp=HP, **kw):
    *_, (train_b, eval_b, _) = _tiny()
    kw.setdefault("rounds", ROUNDS)
    return run_federated(0, _tiny()[3], train_b, eval_b, strategy=_port_strategy(strategy),
                         hp=HyperParams(**hp), server=_port_server(), engine=engine,
                         device="cpu", **kw)


def _losses(res):
    return [m["mean_loss"] for m in res.round_metrics]


def assert_run_matches(got, want, what, loss_tol=1e-5, adapter_tol=ADAPTER_TOL):
    """Round metrics (losses at ``loss_tol``, the rest exactly), comm totals,
    and the global, client and personal adapters at ``adapter_tol``."""
    wl, gl = _losses(want), _losses(got)
    assert [{k: v for k, v in m.items() if k != "mean_loss"} for m in got.round_metrics] == \
        [{k: v for k, v in m.items() if k != "mean_loss"} for m in want.round_metrics], what
    for g, w in zip(gl, wl):
        assert (g is None) if w is None else abs(g - w) <= loss_tol * abs(w), (what, gl, wl)
    assert got.comm_totals == want.comm_totals, what
    assert got.server.round_idx == want.server.round_idx, what
    # ``want``: a JAX run's trees, or the port's (numpy takes CPU tensors as they are)
    assert_tree_close(got.server.global_adapters, want.server.global_adapters, adapter_tol,
                      f"{what} global")
    for cg, cw in zip(got.clients, want.clients):
        assert cg.rounds_participated == cw.rounds_participated, what
        assert_tree_close(cg.adapters, cw.adapters, adapter_tol, f"{what} client")
        if cw.local_adapters is not None:
            assert_tree_close(cg.local_adapters, cw.local_adapters, adapter_tol,
                              f"{what} personal")


# ---------------------------------------------------------------------------
# against the JAX vmap engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", PAPER_STRATEGIES)
def test_vmap_matches_reference(strategy):
    want = _jax_run(strategy)
    got = _port_run(strategy)
    assert got.engine == "vmap" and got.setup_s >= 0.0
    assert [m["participants"] for m in got.round_metrics] == [len(CIDS)] * ROUNDS
    assert_run_matches(got, want, strategy)
    assert got.client_accuracy == want.client_accuracy


@pytest.mark.parametrize("strategy", ["locft", "fednano"])
def test_vmap_under_a_sampler_matches_reference(strategy):
    """Cohorts of 2 of 3 drawn by the JAX ``FixedSizeSampler``: under LocFT a
    client first sampled after round 0 downloads while the others do not,
    so a round runs two flag groups; only the clients that download are
    charged the broadcast."""
    rounds = 4
    jsampler = JFixedSizeSampler(n=2, seed=11)
    want = _jax_run(strategy, sampler=jsampler, rounds=rounds)
    got = _port_run(strategy, sampler=_Replay(jax_sampler=jsampler), rounds=rounds)
    assert_run_matches(got, want, strategy)
    cohorts = [jsampler.select(r, CIDS) for r in range(rounds)]
    seen, downloads = set(), 0
    for cohort in cohorts:
        downloads += sum(1 for c in cohort if strategy != "locft" or c not in seen)
        seen.update(cohort)
    gbytes = sum(a.nbytes for m in _tiny()[5].values() for a in m.values())
    assert got.comm_totals["param_down"] == downloads * gbytes
    if strategy == "locft":
        assert len(seen) == 3 and downloads == 3  # some round mixed the two groups


@pytest.mark.parametrize("agg_chunk", [2, 3])
def test_vmap_agg_chunk_matches_reference_and_full_merge(agg_chunk):
    """Chunks of 2 (cohorts of 2 and 1) or 3 clients folded into FedNano's
    streaming merge: against the JAX engine at the same ``agg_chunk``, and
    against the port's full merge (f32 summation order through AdamW)."""
    got = _port_run("fednano", agg_chunk=agg_chunk)
    assert_run_matches(got, _jax_run("fednano", agg_chunk=agg_chunk), f"chunk {agg_chunk}")
    full = _port_run("fednano")
    assert_tree_close(got.server.global_adapters, full.server.global_adapters,
                      ADAPTER_TOL, "chunked vs full merge")
    assert got.comm_totals == full.comm_totals


def test_ragged_cohort_raises_as_the_reference():
    """Clients with different numbers of Fisher batches, and a cohort whose
    schedule flags differ: the JAX package's ``ValueError`` texts."""
    jcfg, _, _, cfg, *_ = _tiny()
    kw = dict(TINY_DATA, alpha=0.3, examples_per_client=12)
    jtrain, jeval, _ = jax_make_data(jcfg, **kw)
    train_b, eval_b, _ = make_federated_data(cfg, device="cpu", **kw)
    assert len({len(b) for b in train_b.values()}) > 1
    with pytest.raises(ValueError) as want:
        jax_run_federated(jax.random.PRNGKey(0), jcfg, jtrain, jeval, rounds=1,
                          hp=JHyperParams(lr=5e-3, local_steps=1, fisher_batches=100),
                          engine="vmap")
    with pytest.raises(ValueError) as got:
        run_federated(0, cfg, train_b, eval_b, rounds=1, device="cpu", engine="vmap",
                      hp=HyperParams(lr=5e-3, local_steps=1, fisher_batches=100))
    assert str(got.value) == str(want.value) and "ragged" in str(got.value)

    states = [FedDPAF().init_client(torch.Generator().manual_seed(c), cfg, c, 3) for c in CIDS]
    states[1] = dataclasses.replace(states[1], rounds_participated=1)
    with pytest.raises(ValueError, match="uniform download/warmup schedules"):
        client_lib.prepare_cohort(cfg, states, [train_b[c] for c in CIDS],
                                  HyperParams(**HP), "feddpa_f")


def test_unknown_engine_raises():
    """The reference's ``ValueError``."""
    *_, (train_b, eval_b, _) = _tiny()
    with pytest.raises(ValueError, match="unknown engine 'pmap'"):
        run_federated(0, _tiny()[3], train_b, eval_b, rounds=1, device="cpu", engine="pmap")


# ---------------------------------------------------------------------------
# against the port's sequential engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", sorted(available_strategies()))
def test_vmap_equals_sequential(strategy):
    hp = dict(HP, dpa_warmup_rounds=1)
    assert_run_matches(_port_run(strategy, hp=hp), _port_run(strategy, "sequential", hp=hp),
                       strategy)


def test_zero_fisher_batches_give_the_floor():
    """``fisher_batches=0``: every client's Fisher is the eps floor (1e-8),
    as the JAX vmap engine's ``full_like(x, 1e-8)``, and the run equals the
    sequential engine's."""
    hp = dict(HP, fisher_batches=0)
    got = _port_run("fednano", hp=hp)
    assert all(bool((leaf == 1e-8).all()) for c in got.clients for leaf in tree_leaves(c.fisher))
    assert_run_matches(got, _port_run("fednano", "sequential", hp=hp), "no Fisher batches")


FAMILY_ARCHS = {
    # arch: (config overrides, data overrides)
    "h2o-danube-1.8b": ({}, dict(seq_len=16)),
    "qwen2-vl-72b": ({}, dict(seq_len=16)),
    "llama4-scout-17b-a16e": ({}, dict(seq_len=12)),
    "grok-1-314b": ({}, dict(seq_len=12)),
    "mamba2-130m": ({}, dict(seq_len=40)),
    "recurrentgemma-9b": (dict(n_layers=5), dict(seq_len=16)),
    "whisper-base": ({}, dict(seq_len=16)),
}


@pytest.mark.parametrize("arch", list(FAMILY_ARCHS))
def test_vmap_equals_sequential_by_family(arch, monkeypatch):
    """Two FedNano rounds of 3 clients at each family's smoke size, the
    kernels' plain versions on (``use_pallas``). For the MoE pair the
    capacity of each client's routing group drops choices (asserted), so a
    group that straddled two clients would change the losses."""
    over, dkw = FAMILY_ARCHS[arch]
    cfg = get_smoke_config(arch, **over).with_(use_pallas=True)
    data = dict(n_clients=3, examples_per_client=8, alpha=100.0, batch_size=2, seed=0, **dkw)
    train_b, eval_b, _ = make_federated_data(cfg, device="cpu", **data)
    runs = {}
    for engine in ("sequential", "vmap"):
        routes, route = [], moe.route
        monkeypatch.setattr(moe, "route", lambda *a: routes.append(route(*a)) or routes[-1])
        runs[engine] = run_federated(
            0, cfg, train_b, eval_b, strategy="fednano", rounds=ROUNDS,
            hp=HyperParams(**HP), use_pallas=True, engine=engine, device="cpu",
            server=init_server(cfg, seed=0, device="cpu"))
        monkeypatch.setattr(moe, "route", route)
        if cfg.family == "moe":
            assert sum(int((~r.keep).sum()) for r in routes) > 0, "no choice dropped"
    assert_run_matches(runs["vmap"], runs["sequential"], arch)


# ---------------------------------------------------------------------------
# the places where folding could mix clients
# ---------------------------------------------------------------------------

def _trees(seed, k, scales):
    rng = np.random.default_rng(seed)
    shapes = {"text": {"down": (32, 4), "up": (4, 32)}, "image": {"down": (32, 4),
                                                                  "up": (4, 32)}}
    return [{m: {n: torch.from_numpy((rng.standard_normal(sh) * s).astype(np.float32))
                 for n, sh in d.items()} for m, d in shapes.items()} for s in scales[:k]]


def _hold_rows(stacked, per_client, tol=1e-6):
    for i, want in enumerate(per_client):
        for g, w in zip(tree_leaves(tree_unstack(stacked, len(per_client))[i]),
                        tree_leaves(want)):
            assert float((g - w).abs().max()) <= tol * max(float(w.abs().max()), 1e-30), i


def test_stacked_adamw_clips_each_client_by_its_own_norm():
    """Two clients with gradient norms far apart, the clip of 1.0 active for
    one only: each row equals that client's own update, and a clip over the
    stacked tree would have scaled the other."""
    params = _trees(0, 2, [1.0, 1.0])
    grads = _trees(1, 2, [3.0, 0.01])
    norms = [float(sum((g ** 2).sum() for g in tree_leaves(t)) ** 0.5) for t in grads]
    assert norms[0] > 1.0 > norms[1]
    states = [adamw_init(p) for p in params]
    kw = dict(lr=5e-3, weight_decay=0.01, grad_clip=1.0)
    got_p, got_s = adamw_update_many(tree_stack(grads), tree_stack(states), tree_stack(params),
                                     **kw)
    want = [adamw_update(g, s, p, **kw) for g, s, p in zip(grads, states, params)]
    _hold_rows(got_p, [w[0] for w in want])
    _hold_rows(got_s.mu, [w[1].mu for w in want])
    _hold_rows(got_s.nu, [w[1].nu for w in want])
    # one clip over both rows would have scaled client 1's moment too
    joint = adamw_update(tree_stack(grads), tree_stack(states), tree_stack(params), **kw)[1]
    assert not torch.allclose(tree_unstack(joint.mu, 2)[1]["text"]["up"],
                              want[1][1].mu["text"]["up"])


def test_stacked_adamw_takes_each_clients_step():
    """Clients at AdamW steps 1 and 6 (a sampler let one train more): each
    row's bias correction is its own."""
    params = _trees(2, 2, [1.0, 1.0])
    grads = _trees(3, 2, [0.1, 0.1])
    mom = _trees(4, 2, [0.01, 0.01])
    states = [adamw_init(p)._replace(mu=m, nu=tree_map(torch.square, m),
                                     step=torch.tensor(s, dtype=torch.int32))
              for p, m, s in zip(params, mom, (0, 5))]
    got_p, got_s = adamw_update_many(tree_stack(grads), tree_stack(states), tree_stack(params),
                                     lr=5e-3, grad_clip=1.0)
    want = [adamw_update(g, s, p, lr=5e-3, grad_clip=1.0)
            for g, s, p in zip(grads, states, params)]
    assert got_s.step.tolist() == [1, 6]
    _hold_rows(got_p, [w[0] for w in want])


def test_moe_groups_stay_inside_one_client(monkeypatch):
    """Three clients' rows through llama4's smoke MoE in one folded pass:
    each client's loss equals its own pass, the routing groups are each
    client's (drops asserted), and the balance loss is per client. One group
    over the three clients' tokens would route (and drop) otherwise."""
    cfg = get_smoke_config("llama4-scout-17b-a16e")
    server = init_server(cfg, seed=0, device="cpu")
    train_b, _, _ = make_federated_data(cfg, device="cpu", n_clients=3, examples_per_client=4,
                                        alpha=100.0, batch_size=2, seq_len=12, seed=0)
    batches = [train_b[c][0] for c in range(3)]
    adapters = [server.global_adapters] * 3
    routes, route = [], moe.route
    monkeypatch.setattr(moe, "route", lambda *a: routes.append(route(*a)) or routes[-1])
    got, aux = client_lib.cohort_loss(cfg, server.backbone, tree_stack(adapters), None,
                                      tree_stack(batches), 3)
    folded = list(routes)
    routes.clear()
    want = [client_lib.combined_loss(cfg, server.backbone, a, None, b)
            for a, b in zip(adapters, batches)]
    per_client = list(routes)
    assert aux.shape == (3,)
    for i, (w, waux) in enumerate(want):
        assert abs(float(got[i]) - float(w)) <= 1e-6 * abs(float(w)), i
        assert abs(float(aux[i]) - float(waux)) <= 1e-6 * abs(float(waux)), i
    tokens = 2 * 12
    assert all(r.idx.shape[1] == moe._group_size(tokens) for r in folded)
    assert sum(r.idx.shape[0] for r in folded) == sum(r.idx.shape[0] for r in per_client)
    assert sum(int((~r.keep).sum()) for r in folded) > 0
    # one group over all three clients' tokens routes them otherwise
    assert moe.capacity(cfg, moe._group_size(3 * tokens)) != moe.capacity(
        cfg, moe._group_size(tokens))


def test_cohort_loss_is_each_clients_own_mean():
    """Clients with 3, 9 and 1 supervised positions: the folded loss is each
    client's masked sum over its own count, not the cohort's mean."""
    rng = np.random.default_rng(0)
    k, b, s, v = 3, 2, 6, 11
    logits = torch.from_numpy(rng.standard_normal((k * b, s, v)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, v, (k * b, s)))
    mask = torch.zeros((k * b, s))
    for i, n in enumerate((3, 9, 1)):
        mask[i * b:(i + 1) * b].view(-1)[:n] = 1.0
    got = layers.lm_loss(logits, labels, mask, clients=k)
    want = [layers.lm_loss(logits[i * b:(i + 1) * b], labels[i * b:(i + 1) * b],
                           mask[i * b:(i + 1) * b]) for i in range(k)]
    for g, w in zip(got, want):
        assert abs(float(g) - float(w)) <= 1e-6 * abs(float(w))
    assert abs(float(got.mean()) - float(layers.lm_loss(logits, labels, mask))) > 1e-3


def test_feddpa_warmup_state_carried_across_rounds():
    """Warmup for two rounds of three: the personal adapters and their AdamW
    state (steps 2 x 3 batches after the warmup) come out of the vmap engine
    as out of the sequential one, and stop moving after the warmup."""
    hp = dict(HP, dpa_warmup_rounds=2)
    got = _port_run("feddpa_f", hp=hp, rounds=3)
    want = _port_run("feddpa_f", "sequential", hp=hp, rounds=3)
    assert_run_matches(got, want, "feddpa_f warmup")
    for cg, cw in zip(got.clients, want.clients):
        assert int(cg.local_opt_state.step) == int(cw.local_opt_state.step) == 2 * 2
        assert_tree_close(cg.local_opt_state.mu, cw.local_opt_state.mu, ADAPTER_TOL,
                          "personal mu")


def test_cohort_gradient_is_each_clients_own():
    """One cohort step of FedProx (its proximal term on each client's own
    row): the stacked gradient's rows against each client's own gradient."""
    cfg, server = _tiny()[3], _port_server()
    *_, (train_b, _, _) = _tiny()
    rng = np.random.default_rng(9)
    adapters = [tree_map(lambda x: x + torch.from_numpy(
        (rng.standard_normal(x.shape) * 0.05).astype(np.float32)), server.global_adapters)
        for _ in CIDS]
    batches = [train_b[c][1] for c in CIDS]
    hp = HyperParams(**HP)
    strat = get_strategy("fedprox")
    opt = tree_stack([adamw_init(a) for a in adapters])
    _, _, losses, grads = client_lib.cohort_train_step(
        cfg, strat, hp, server.backbone, tree_stack(adapters), opt, tree_stack(batches),
        server.global_adapters, len(CIDS))
    for i, (a, b) in enumerate(zip(adapters, batches)):
        loss, _, g = client_lib.value_and_grad(strat.wrap_local_loss(
            lambda adp: client_lib.combined_loss(cfg, server.backbone, adp, None, b), hp,
            server.global_adapters), a)
        assert abs(float(losses[i]) - float(loss)) <= 1e-6 * abs(float(loss))
        _hold_rows(tree_map(lambda x: x[i:i + 1], grads), [g], tol=1e-5)


# ---------------------------------------------------------------------------
# resume and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", ["fednano", "feddpa_f"])
def test_vmap_resume_equivalence(tmp_path, strategy):
    """A vmap run cut after round 2 and resumed equals the uninterrupted one;
    its snapshot refuses a sequential resume."""
    hp = dict(HP, dpa_warmup_rounds=3)
    d = str(tmp_path / "state")
    full = _port_run(strategy, hp=hp, rounds=4)
    _port_run(strategy, hp=hp, rounds=2, checkpoint_dir=d, final_eval=False)
    resumed = _port_run(strategy, hp=hp, rounds=4, resume=d)
    assert_equivalent(full, resumed)
    with pytest.raises(CheckpointError, match="engine"):
        _port_run(strategy, "sequential", hp=hp, rounds=4, resume=d)


@pytest.mark.parametrize("engine", ["vmap", "buffered"])
def test_train_cli_engines_on_cpu(tmp_path, capsys, engine):
    args = ["--device", "cpu", "--engine", engine, "--clients", "3", "--rounds", "2",
            "--local-steps", "2", "--examples-per-client", "8", "--alpha", "100",
            "--batch-size", "2", "--seq-len", "8", "--out", str(tmp_path)]
    if engine == "buffered":
        args += ["--buffer-size", "2", "--straggler-prob", "0.3"]
    assert train.main(args) == 0
    out = capsys.readouterr().out
    assert ("merge 1" if engine == "buffered" else "round 1") in out
