"""Resume and failure injection in the port's round engine, against itself
and against the JAX package.

The contract (JAX ``tests/test_resume.py``): a run checkpointed at round r
and resumed to round R gives the numbers of an uninterrupted R-round run,
within 1e-6, because nothing random is carried (client init from ``seed +
2``, DP noise per (cid, round), samplers and failures per (seed, round))
and ``RunState`` keeps every carried state: ServerOpt moments, the
clients' AdamW moments (shared and personal), FedDPA-F's warmup counters,
transform residuals, the comm log. These run on the JAX package's tiny
config (1 layer, d 32).

Against the JAX package: the port's run cut after round 1 and resumed to
round 2 is held against a live, uninterrupted JAX run on the server and
data ``test_torch_training.py`` shares (losses 1e-5, adapters at its
``ADAPTER_TOL``); and under one fixed failure schedule, which neither
package can draw from the other's ``FailureModel``, so this file subclasses
both to read the same table of (cid, round) -> drop / crash.
"""
import dataclasses
import json
import math
import os

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import FailureModel as JFailureModel
from repro.core import HyperParams as JHyperParams
from repro.core import run_federated as jax_run_federated
from repro.core import server as jserver
from repro.core.comm import CommLog as JCommLog
from repro.data import make_federated_data as jax_make_data
from repro_torch import interop
from repro_torch.checkpoint import CheckpointError, read_run_meta
from repro_torch.configs import get_smoke_config
from repro_torch.core import FailureModel, HyperParams, ServerState, run_federated
from repro_torch.data import make_federated_data
from repro_torch.strategies import FedAdamOpt, FixedSizeSampler, Int8EFQuant, TopKSparsify
from repro_torch.utils import tree_bytes, tree_flatten_with_path

import test_torch_training as tt
from test_torch_checkpoint import TINY, TINY_DATA
from test_torch_training import one_torch_thread  # noqa: F401  (autouse fixture)

PAPER_STRATEGIES = ("fednano", "fednano_ef", "fedavg", "fedprox", "feddpa_f", "locft")
ROUNDS = 4
CUT = 2


@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke_config("llava-1.5-7b").with_(**TINY)
    train, evald, _ = make_federated_data(cfg, device="cpu", **TINY_DATA)
    return cfg, train, evald


def _hp(**kw):
    kw.setdefault("lr", 5e-3)
    kw.setdefault("local_steps", 1)
    kw.setdefault("fisher_batches", 1)
    return HyperParams(**kw)


def _tree_err(got, want):
    """max |got - want| / ‖want‖∞ over the leaves of two trees, paired by
    path (a restored tree keeps its reference's key order)."""
    g, w = dict(tree_flatten_with_path(got)), dict(tree_flatten_with_path(want))
    assert sorted(g) == sorted(w)
    return max(float((g[k] - w[k]).abs().max()) / max(float(w[k].abs().max()), 1e-30)
               for k in w)


def assert_equivalent(full, resumed, tol=1e-6):
    """Every observable of the resumed run matches the uninterrupted one."""
    fl = [m["mean_loss"] for m in full.round_metrics]
    rl = [m["mean_loss"] for m in resumed.round_metrics]
    assert len(fl) == len(rl)
    for a, b in zip(fl, rl):
        assert (a is None) == (b is None) and (a is None or abs(a - b) <= tol * abs(a)), (fl, rl)
    assert [{k: v for k, v in m.items() if k != "mean_loss"} for m in full.round_metrics] == \
        [{k: v for k, v in m.items() if k != "mean_loss"} for m in resumed.round_metrics]
    assert resumed.comm_totals == full.comm_totals
    assert resumed.avg_accuracy == pytest.approx(full.avg_accuracy, abs=1e-9)
    assert _tree_err(resumed.server.global_adapters, full.server.global_adapters) <= tol
    assert resumed.server.round_idx == full.server.round_idx
    for cf, cr in zip(full.clients, resumed.clients):
        assert _tree_err(cr.adapters, cf.adapters) <= tol
        assert cf.rounds_participated == cr.rounds_participated
        if cf.local_adapters is not None:
            assert _tree_err(cr.local_adapters, cf.local_adapters) <= tol


def _kill_and_resume(setup, tmp_path, strategy, *, hp=None, **kw):
    """CUT rounds + save, then resume to ROUNDS. -> (full, resumed, snapshot dir)."""
    cfg, train, evald = setup
    hp = hp or _hp()
    d = str(tmp_path / "state")
    full = run_federated(0, cfg, train, evald, strategy=strategy, rounds=ROUNDS, hp=hp,
                         device="cpu", **kw)
    run_federated(0, cfg, train, evald, strategy=strategy, rounds=CUT, hp=hp, device="cpu",
                  checkpoint_dir=d, final_eval=False, **kw)
    resumed = run_federated(0, cfg, train, evald, strategy=strategy, rounds=ROUNDS, hp=hp,
                            device="cpu", resume=d, **kw)
    return full, resumed, d


# ---------------------------------------------------------------------------
# resume equivalence: every paper strategy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", PAPER_STRATEGIES)
def test_resume_equivalence_sequential(setup, tmp_path, strategy):
    hp = _hp(dpa_warmup_rounds=1) if strategy == "feddpa_f" else _hp()
    full, resumed, d = _kill_and_resume(setup, tmp_path, strategy, hp=hp)
    assert_equivalent(full, resumed)
    assert read_run_meta(os.path.join(d, f"round_{CUT:06d}"))["round_idx"] == CUT
    assert open(os.path.join(d, "LATEST")).read() == f"round_{CUT:06d}"


def test_resume_restores_server_opt_moments(setup, tmp_path):
    """FedAdam's m and v come back: re-zeroed moments would still run (the
    shapes match) but take other steps."""
    full, resumed, _ = _kill_and_resume(setup, tmp_path, "fedavg",
                                        server_opt=FedAdamOpt(lr=0.5))
    assert set(resumed.server_opt_state) == {"m", "v"}
    for k in ("m", "v"):
        assert _tree_err(resumed.server_opt_state[k], full.server_opt_state[k]) <= 1e-6
    assert_equivalent(full, resumed)


def test_resume_mid_warmup_feddpa(setup, tmp_path):
    """A cut inside the personal adapter's warmup: ``rounds_participated`` and
    the personal AdamW state (``client_ref_like``'s template) must come back."""
    hp = _hp(dpa_warmup_rounds=CUT + 1)
    full, resumed, d = _kill_and_resume(setup, tmp_path, "feddpa_f", hp=hp)
    assert_equivalent(full, resumed)
    meta = read_run_meta(d + f"/round_{CUT:06d}")
    assert all(c["has_local"] and c["has_local_opt"] for c in meta["clients"])
    for cf, cr in zip(full.clients, resumed.clients):
        assert _tree_err(cr.local_opt_state.mu, cf.local_opt_state.mu) <= 1e-6


@pytest.mark.parametrize("transform", [Int8EFQuant(), TopKSparsify(frac=0.25)],
                         ids=["int8_ef", "topk"])
def test_resume_restores_transform_residuals(setup, tmp_path, transform):
    full, resumed, d = _kill_and_resume(setup, tmp_path, "fedavg", transforms=(transform,))
    assert read_run_meta(d + f"/round_{CUT:06d}")["tstate_present"] == [[True]] * 3
    assert_equivalent(full, resumed)


def test_resume_partial_participation(setup, tmp_path):
    """The sampler is stateless: the resumed run draws round r's cohort from
    (seed, r) again."""
    full, resumed, _ = _kill_and_resume(setup, tmp_path, "fednano",
                                        sampler=FixedSizeSampler(n=2, seed=11))
    assert [m["participants"] for m in full.round_metrics] == [2] * ROUNDS
    assert_equivalent(full, resumed)


def test_resume_with_failures(setup, tmp_path):
    fm = FailureModel(dropout_prob=0.3, crash_prob=0.3, seed=5)
    full, resumed, d = _kill_and_resume(setup, tmp_path, "fednano", failures=fm)
    dropped = [m["dropped"] for m in full.round_metrics]
    crashed = [m["crashed"] for m in full.round_metrics]
    assert sum(dropped) > 0 and sum(crashed) > 0, (dropped, crashed)
    assert_equivalent(full, resumed)
    assert read_run_meta(d + f"/round_{CUT:06d}")["failure_model"] == fm.to_dict()


def test_checkpoint_every_and_final_snapshot(setup, tmp_path):
    cfg, train, evald = setup
    d = str(tmp_path / "state")
    run_federated(0, cfg, train, evald, rounds=3, hp=_hp(), device="cpu", checkpoint_dir=d,
                  checkpoint_every=2, final_eval=False)
    assert sorted(os.listdir(d)) == ["LATEST", "round_000002", "round_000003"]
    assert open(os.path.join(d, "LATEST")).read() == "round_000003"


# ---------------------------------------------------------------------------
# resume validation: a checkpoint never replays the wrong run
# ---------------------------------------------------------------------------

def test_resume_rejects_mismatched_run(setup, tmp_path):
    cfg, train, evald = setup
    d = str(tmp_path / "state")
    run_federated(0, cfg, train, evald, strategy="fednano", rounds=1, hp=_hp(), device="cpu",
                  checkpoint_dir=d, final_eval=False)

    def resume(**kw):
        args = dict(strategy="fednano", rounds=2, hp=_hp(), device="cpu", resume=d)
        args.update(kw)
        return run_federated(args.pop("seed", 0), args.pop("cfg", cfg), train, evald, **args)

    with pytest.raises(CheckpointError, match="strategy"):
        resume(strategy="fedavg")
    with pytest.raises(CheckpointError, match="hyperparameters"):
        resume(hp=_hp(lr=1e-2))
    with pytest.raises(CheckpointError, match="transform chain"):
        resume(transforms=(Int8EFQuant(),))
    with pytest.raises(CheckpointError, match="config"):
        resume(cfg=cfg.with_(name="other"))
    with pytest.raises(CheckpointError, match="different seed"):
        resume(seed=1)
    meta_path = os.path.join(d, "round_000001", "meta.json")
    meta = json.loads(open(meta_path).read())
    meta["engine"] = "vmap"
    open(meta_path, "w").write(json.dumps(meta))
    with pytest.raises(CheckpointError, match="engine"):
        resume()


def test_resume_refuses_a_jax_snapshot(tmp_path):
    """A JAX-written snapshot loads in the port, but its rng_key is a JAX key,
    so resuming it would not replay and is refused."""
    jcfg = jax_smoke_config("llava-1.5-7b").with_(**TINY)
    jtrain, jeval, _ = jax_make_data(jcfg, **TINY_DATA)
    d = str(tmp_path / "jax")
    jax_run_federated(jax.random.PRNGKey(0), jcfg, jtrain, jeval, rounds=1,
                      hp=JHyperParams(lr=5e-3, local_steps=1, fisher_batches=1),
                      checkpoint_dir=d, final_eval=False)
    cfg = get_smoke_config("llava-1.5-7b").with_(**TINY)
    train, evald, _ = make_federated_data(cfg, device="cpu", **TINY_DATA)
    with pytest.raises(CheckpointError, match="different seed"):
        run_federated(0, cfg, train, evald, rounds=2, hp=_hp(), device="cpu", resume=d)


# ---------------------------------------------------------------------------
# FailureModel: the contract
# ---------------------------------------------------------------------------

def test_failure_model_is_stateless_and_seeded():
    fm = FailureModel(dropout_prob=0.3, crash_prob=0.2, straggler_prob=0.1, seed=7)
    grid = [(c, r) for c in range(6) for r in range(6)]
    first = [(fm.drops(c, r), fm.crashes(c, r)) for c, r in grid]
    again = [(fm.drops(c, r), fm.crashes(c, r)) for c, r in reversed(grid)][::-1]
    assert first == again  # no carried state: the order of the calls changes nothing
    assert first == [(x.drops(c, r), x.crashes(c, r)) for x in
                     [FailureModel(dropout_prob=0.3, crash_prob=0.2, straggler_prob=0.1,
                                   seed=7)] for c, r in grid]
    other = FailureModel(dropout_prob=0.3, crash_prob=0.2, straggler_prob=0.1, seed=8)
    assert first != [(other.drops(c, r), other.crashes(c, r)) for c, r in grid]
    assert not FailureModel().active and fm.active
    off = FailureModel(seed=7)
    assert not any(off.drops(c, r) or off.crashes(c, r) for c, r in grid)


def test_failure_model_shares_and_independence():
    """Over 10,000 (cid, round) draws each share is within 4σ of its
    probability, and the kinds are independent (the joint share is the
    product's)."""
    p = dict(dropout_prob=0.3, crash_prob=0.2)
    fm = FailureModel(seed=3, **p)
    grid = [(c, r) for c in range(100) for r in range(100)]
    n = len(grid)
    draws = np.array([(fm.drops(c, r), fm.crashes(c, r)) for c, r in grid])
    probs = np.array([p["dropout_prob"], p["crash_prob"]])
    for share, q in zip(draws.mean(0), probs):
        assert abs(share - q) <= 4 * math.sqrt(q * (1 - q) / n), (share, q)
    q = probs[0] * probs[1]
    joint = float((draws[:, 0] & draws[:, 1]).mean())
    assert abs(joint - q) <= 4 * math.sqrt(q * (1 - q) / n), (joint, q)


def test_failure_model_fields_and_checks_are_the_reference():
    kw = dict(dropout_prob=0.25, crash_prob=0.5, straggler_prob=0.125, straggler_ticks=2, seed=9)
    assert FailureModel(**kw).to_dict() == JFailureModel(**kw).to_dict()
    assert FailureModel().to_dict() == JFailureModel().to_dict()
    for bad in (dict(dropout_prob=1.0), dict(crash_prob=-0.1), dict(straggler_prob=1.5),
                dict(straggler_ticks=0)):
        with pytest.raises(ValueError) as mine:
            FailureModel(**bad)
        with pytest.raises(ValueError) as ref:
            JFailureModel(**bad)
        assert str(mine.value) == str(ref.value)


# ---------------------------------------------------------------------------
# the engine under one fixed schedule, against the JAX engine
# ---------------------------------------------------------------------------

# (cid, round) -> what happens: every kind of round, one with no survivor
SCHEDULE = {(1, 0): "drop", (0, 1): "crash", (2, 1): "drop", (0, 2): "crash",
            (1, 2): "crash", (2, 2): "drop", (1, 3): "crash"}
FIXED_ROUNDS = 4


@dataclasses.dataclass(frozen=True)
class JTable(JFailureModel):
    def drops(self, cid, round_idx):
        return SCHEDULE.get((cid, round_idx)) == "drop"

    def crashes(self, cid, round_idx):
        return SCHEDULE.get((cid, round_idx)) == "crash"


@dataclasses.dataclass(frozen=True)
class Table(FailureModel):
    def drops(self, cid, round_idx):
        return SCHEDULE.get((cid, round_idx)) == "drop"

    def crashes(self, cid, round_idx):
        return SCHEDULE.get((cid, round_idx)) == "crash"


@pytest.fixture(scope="module")
def fixed():
    """The JAX-drawn tiny server (numpy), both packages' data."""
    jcfg = jax_smoke_config("llava-1.5-7b").with_(**TINY)
    cfg = get_smoke_config("llava-1.5-7b").with_(**TINY)
    jsrv = jserver.init_server(jax.random.PRNGKey(3), jcfg)
    return (jcfg, jsrv, jax_make_data(jcfg, **TINY_DATA), cfg,
            jax.tree.map(np.asarray, jsrv.backbone),
            jax.tree.map(np.asarray, jsrv.global_adapters),
            make_federated_data(cfg, device="cpu", **TINY_DATA))


@pytest.mark.parametrize("strategy", ["fednano", "fedavg"])
def test_fixed_schedule_matches_reference_and_survives_resume(fixed, tmp_path, strategy):
    jcfg, jsrv, (jtrain, jeval, _), cfg, backbone, adapters, (train, evald, _) = fixed
    hp = dict(lr=5e-3, local_steps=1, fisher_batches=1)
    want = jax_run_federated(jax.random.PRNGKey(0), jcfg, jtrain, jeval, strategy=strategy,
                             rounds=FIXED_ROUNDS, hp=JHyperParams(**hp),
                             server=dataclasses.replace(jsrv, comm=JCommLog()),
                             failures=JTable(dropout_prob=0.5, crash_prob=0.5))

    def server():
        return ServerState(cfg=cfg, backbone=interop.backbone_from_numpy(cfg, backbone, "cpu"),
                           global_adapters=interop.adapters_from_numpy(adapters, "cpu"))

    fm = Table(dropout_prob=0.5, crash_prob=0.5)
    kw = dict(strategy=strategy, hp=HyperParams(**hp), failures=fm, device="cpu")
    d = str(tmp_path / "state")
    full = run_federated(0, cfg, train, evald, rounds=FIXED_ROUNDS, server=server(), **kw)
    run_federated(0, cfg, train, evald, rounds=2, server=server(), checkpoint_dir=d,
                  final_eval=False, **kw)
    resumed = run_federated(0, cfg, train, evald, rounds=FIXED_ROUNDS, server=server(),
                            resume=d, **kw)
    assert_equivalent(full, resumed)

    for got in (full, resumed):
        assert [{k: v for k, v in m.items() if k != "mean_loss"} for m in got.round_metrics] \
            == [{k: v for k, v in m.items() if k != "mean_loss"} for m in want.round_metrics]
        for g, w in zip(got.round_metrics, want.round_metrics):
            assert (g["mean_loss"] is None) == (w["mean_loss"] is None)
            if w["mean_loss"] is not None:
                assert abs(g["mean_loss"] - w["mean_loss"]) <= 1e-5 * abs(w["mean_loss"])
        assert got.comm_totals == want.comm_totals
        tt.assert_tree_close(got.server.global_adapters, want.server.global_adapters,
                             tt.ADAPTER_TOL, "global adapters")
        assert [c.rounds_participated for c in got.clients] == \
            [c.rounds_participated for c in want.clients]
    assert [m["participants"] for m in full.round_metrics] == [2, 1, 0, 2]

    # every byte by hand: dropped clients move nothing, crashed ones one download
    gbytes = tree_bytes(full.server.global_adapters)
    down = sum(gbytes for c in range(3) for r in range(FIXED_ROUNDS)
               if SCHEDULE.get((c, r)) != "drop")
    up = sum(gbytes for c in range(3) for r in range(FIXED_ROUNDS) if (c, r) not in SCHEDULE)
    assert full.comm_totals["param_down"] == down
    assert full.comm_totals["param_up"] == up
    assert full.comm_totals["fisher_up"] == (up if strategy == "fednano" else 0)


# ---------------------------------------------------------------------------
# the port's resumed run against a live uninterrupted JAX run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("strategy", ["fednano", "fedavg"])
def test_resumed_run_matches_live_reference(tmp_path, strategy, use_pallas):
    """Smoke llava, 2 clients: the reference runs ``tt.ROUNDS`` rounds at
    once, the port runs one, saves, and resumes to ``tt.ROUNDS``."""
    jcfg, (jtrain, jeval, _), cfg, (train, evald, _) = tt._data(use_pallas)
    jpallas = tt._jax_pallas(tt.ARCH, use_pallas)
    want = jax_run_federated(jax.random.PRNGKey(0), jcfg, jtrain, jeval, strategy=strategy,
                             rounds=tt.ROUNDS, hp=JHyperParams(**tt.HP), use_pallas=jpallas,
                             server=dataclasses.replace(tt._server()[0], comm=JCommLog()))
    d = str(tmp_path / "state")
    kw = dict(strategy=strategy, hp=HyperParams(**tt.HP), use_pallas=use_pallas)
    run_federated(0, cfg, train, evald, rounds=1, server=tt._port_server(cfg),
                  checkpoint_dir=d, final_eval=False, **kw)
    got = run_federated(0, cfg, train, evald, rounds=tt.ROUNDS, server=tt._port_server(cfg),
                        resume=d, **kw)
    wl = [m["mean_loss"] for m in want.round_metrics]
    gl = [m["mean_loss"] for m in got.round_metrics]
    assert len(gl) == tt.ROUNDS
    for g, w in zip(gl, wl):
        assert abs(g - w) <= 1e-5 * abs(w), (gl, wl)
    assert got.comm_totals == want.comm_totals
    assert got.client_accuracy == want.client_accuracy
    tt.assert_tree_close(got.server.global_adapters, want.server.global_adapters,
                         tt.ADAPTER_TOL, "global adapters")
    assert got.server.round_idx == tt.ROUNDS
    assert [c.rounds_participated for c in got.clients] == [tt.ROUNDS] * 2
