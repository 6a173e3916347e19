"""The port's buffered (FedBuff-style asynchronous) engine against the JAX
package's, on ``test_torch_checkpoint``'s ``TINY`` llava config with the
JAX-drawn server and both packages' data (``test_torch_engine.py``'s).

Uniform latency (every completion in one tick, so merges of ``buffer_size``
of 3 clients take turns), a straggler ``latency_fn`` (client 0 takes 3
ticks) under ``FedBuffOpt(0.5)``, and one fixed table of drops, crashes and
straggles that both packages read (subclassing both ``FailureModel``s, as
``test_torch_resume.py`` does, since neither can draw the other's
schedule). Round losses 1e-5, adapters ``ADAPTER_TOL``; participants,
staleness, failure counts and comm totals exactly. Then LocFT refused,
``FedBuffOpt`` against JAX's at 1e-6, the straggle draw's contract, and a
run cut at merge 2 and resumed equal to the uninterrupted one.
"""
import dataclasses
import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FailureModel as JFailureModel
from repro.core import HyperParams as JHyperParams
from repro.core import run_federated as jax_run_federated
from repro.core.comm import CommLog as JCommLog
from repro.strategies.server_opt import FedBuffOpt as JFedBuffOpt
from repro_torch import interop
from repro_torch.checkpoint import read_run_meta
from repro_torch.core import FailureModel, HyperParams, run_federated
from repro_torch.strategies import FedBuffOpt

from test_torch_engine import _port_server, _tiny, assert_run_matches
from test_torch_resume import assert_equivalent
from test_torch_training import one_torch_thread  # noqa: F401  (autouse fixture)

HP = dict(lr=5e-3, local_steps=1, fisher_batches=1)
MERGES = 4


def slow_client0(cid, version):
    return 3 if cid == 0 else 1


# (cid, tick) -> what happens at that dispatch attempt
SCHEDULE = {(1, 0): "drop", (2, 0): "straggle", (0, 1): "crash", (1, 1): "straggle",
            (2, 4): "drop", (0, 4): "crash", (1, 5): "straggle"}


@dataclasses.dataclass(frozen=True)
class JTable(JFailureModel):
    def drops(self, cid, round_idx):
        return SCHEDULE.get((cid, round_idx)) == "drop"

    def crashes(self, cid, round_idx):
        return SCHEDULE.get((cid, round_idx)) == "crash"

    def straggles(self, cid, round_idx):
        return SCHEDULE.get((cid, round_idx)) == "straggle"


@dataclasses.dataclass(frozen=True)
class Table(FailureModel):
    def drops(self, cid, round_idx):
        return SCHEDULE.get((cid, round_idx)) == "drop"

    def crashes(self, cid, round_idx):
        return SCHEDULE.get((cid, round_idx)) == "crash"

    def straggles(self, cid, round_idx):
        return SCHEDULE.get((cid, round_idx)) == "straggle"


CASES = {
    # name: (strategy, buffer_size, latency_fn, server opt (JAX, port), failures (JAX, port))
    "uniform": ("fednano", 2, None, (None, None), (None, None)),
    "straggler": ("fedavg", 2, slow_client0, (JFedBuffOpt(lr=0.5), FedBuffOpt(lr=0.5)),
                  (None, None)),
    "straggler-fednano": ("fednano", 2, slow_client0,
                          (JFedBuffOpt(lr=0.5), FedBuffOpt(lr=0.5)), (None, None)),
    "failure-table": ("fednano", 2, None, (JFedBuffOpt(lr=0.5), FedBuffOpt(lr=0.5)),
                      (JTable(dropout_prob=0.5, crash_prob=0.5, straggler_prob=0.5,
                              straggler_ticks=2),
                       Table(dropout_prob=0.5, crash_prob=0.5, straggler_prob=0.5,
                             straggler_ticks=2))),
}


@functools.lru_cache(maxsize=None)
def _jax_run(case):
    strategy, bsize, latency_fn, (jopt, _), (jfail, _) = CASES[case]
    jcfg, jsrv, (jtrain, jeval, _), *_ = _tiny()
    return jax_run_federated(jax.random.PRNGKey(0), jcfg, jtrain, jeval, strategy=strategy,
                             rounds=MERGES, hp=JHyperParams(**HP),
                             server=dataclasses.replace(jsrv, comm=JCommLog()),
                             engine="buffered", buffer_size=bsize, latency_fn=latency_fn,
                             server_opt=jopt, failures=jfail)


def _port_run(case, **kw):
    strategy, bsize, latency_fn, (_, opt), (_, fail) = CASES[case]
    *_, (train_b, eval_b, _) = _tiny()
    kw.setdefault("rounds", MERGES)
    return run_federated(0, _tiny()[3], train_b, eval_b, strategy=strategy,
                         hp=HyperParams(**HP), server=_port_server(), engine="buffered",
                         buffer_size=bsize, latency_fn=latency_fn, server_opt=opt,
                         failures=fail, device="cpu", **kw)


@pytest.mark.parametrize("case", list(CASES))
def test_buffered_matches_reference(case):
    want, got = _jax_run(case), _port_run(case)
    assert got.engine == "buffered"
    assert [m["round"] for m in got.round_metrics] == list(range(MERGES))
    assert all(m["participants"] == 2 for m in got.round_metrics)
    assert_run_matches(got, want, case)
    stale = [m["mean_staleness"] for m in got.round_metrics]
    if case == "uniform":
        assert stale[0] == 0.0 and max(stale) > 0.0, stale  # 3 clients, merges of 2
    else:
        assert max(stale) >= 1.0, stale
    if case == "failure-table":
        assert [sum(m[k] for m in got.round_metrics) for k in ("dropped", "crashed",
                                                                "straggled")] == [
            sum(m[k] for m in want.round_metrics) for k in ("dropped", "crashed", "straggled")]
        assert all(sum(m[k] for m in got.round_metrics) > 0
                   for k in ("dropped", "crashed", "straggled"))


def test_buffered_refuses_a_strategy_that_never_merges():
    jcfg, _, (jtrain, jeval, _), cfg, *_, (train_b, eval_b, _) = _tiny()
    with pytest.raises(ValueError) as want:
        jax_run_federated(jax.random.PRNGKey(0), jcfg, jtrain, jeval, strategy="locft",
                          rounds=1, hp=JHyperParams(**HP), engine="buffered")
    with pytest.raises(ValueError) as got:
        run_federated(0, cfg, train_b, eval_b, strategy="locft", rounds=1,
                      hp=HyperParams(**HP), engine="buffered", device="cpu")
    assert str(got.value) == str(want.value) and "local-only" in str(got.value)


@pytest.mark.parametrize("lr", [1.0, 0.5, 0.25])
def test_fedbuff_opt_matches_reference(lr):
    rng = np.random.default_rng(int(lr * 100))
    draw = lambda: {m: {n: rng.standard_normal(sh).astype(np.float32)  # noqa: E731
                        for n, sh in (("down", (32, 4)), ("up", (4, 32)))}
                    for m in ("text", "image")}
    g, m = draw(), draw()
    want, wstate = JFedBuffOpt(lr=lr).apply(None, jax.tree.map(jnp.asarray, g),
                                             jax.tree.map(jnp.asarray, m))
    opt = FedBuffOpt(lr=lr)
    got, state = opt.apply(opt.init(None), interop.adapters_from_numpy(g, "cpu"),
                           interop.adapters_from_numpy(m, "cpu"))
    assert state is None and wstate is None
    got = interop.adapters_to_numpy(got)
    for mod in want:
        for n in want[mod]:
            w = np.asarray(want[mod][n])
            assert np.max(np.abs(got[mod][n] - w)) <= 1e-6 * np.max(np.abs(w))


def test_straggle_draw_is_seeded_stateless_and_independent():
    """The third draw stream: a pure function of (seed, tick, cid), its share
    within 4σ of its probability over 10,000 draws, independent of drops."""
    p = dict(dropout_prob=0.3, straggler_prob=0.2)
    fm = FailureModel(seed=3, **p)
    grid = [(c, r) for c in range(100) for r in range(100)]
    draws = np.array([(fm.drops(c, r), fm.straggles(c, r)) for c, r in grid])
    again = np.array([(fm.drops(c, r), fm.straggles(c, r)) for c, r in reversed(grid)])[::-1]
    assert (draws == again).all()
    n = len(grid)
    for share, q in zip(draws.mean(0), (p["dropout_prob"], p["straggler_prob"])):
        assert abs(share - q) <= 4 * math.sqrt(q * (1 - q) / n), (share, q)
    q = p["dropout_prob"] * p["straggler_prob"]
    joint = float((draws[:, 0] & draws[:, 1]).mean())
    assert abs(joint - q) <= 4 * math.sqrt(q * (1 - q) / n), (joint, q)
    assert not any(FailureModel(seed=3).straggles(c, r) for c, r in grid[:100])


@pytest.mark.parametrize("case", ["straggler", "failure-table"])
def test_buffered_resume_equivalence(tmp_path, case):
    """The uninterrupted run snapshots at tick boundaries after each merge
    (the event heap, pinned versions and part-filled buffer; a tick that
    makes two merges leaves one snapshot); resumed from any of them, a run
    pops the same completions and lands where the uninterrupted run does."""
    d = str(tmp_path / "state")
    full = _port_run(case, checkpoint_dir=d, checkpoint_every=1)
    mids = sorted(n for n in os.listdir(d) if n.startswith("round_")
                  and 0 < int(n.split("_")[1]) < MERGES)
    assert mids, os.listdir(d)
    for snap in mids:
        meta = read_run_meta(os.path.join(d, snap))
        assert meta["engine"] == "buffered" and meta["buffered"]["events"]
        resumed = _port_run(case, resume=os.path.join(d, snap))
        assert_equivalent(full, resumed)
        assert [m["mean_staleness"] for m in resumed.round_metrics] == \
            [m["mean_staleness"] for m in full.round_metrics]


def test_fisher_merge_pairs_leaves_by_key_not_by_dict_order():
    """A resumed buffer entry's θ comes back in the global adapters' key
    order and its F in a fresh client's: FedNano's merge pairs their leaves
    by key (trees flatten dicts in sorted key order, as ``jax.tree_util``),
    so the order the dicts were built in changes nothing."""
    from repro_torch.strategies import get_strategy

    rng = np.random.default_rng(4)
    draw = lambda order: {m: {n: torch.from_numpy(  # noqa: E731
        rng.standard_normal((8, 2) if n == "down" else (2, 8)).astype(np.float32))
        for n in ("up", "down")} for m in order}
    theta, fisher = draw(("image", "text")), draw(("text", "image"))
    fisher = {m: {n: t.abs() for n, t in d.items()} for m, d in fisher.items()}
    flipped = {m: dict(reversed(list(fisher[m].items()))) for m in reversed(list(fisher))}
    strat = get_strategy("fednano")
    merged = [strat.agg_stream_finalize(strat.agg_stream_fold(None, [theta], [f], [3.0]))
              for f in (fisher, flipped)]
    for m in theta:
        for n in theta[m]:
            want = theta[m][n] * fisher[m][n] * 3.0 / (fisher[m][n] * 3.0 + 3e-8)
            for got in merged:
                assert torch.allclose(got[m][n], want, rtol=1e-6, atol=0), (m, n)
