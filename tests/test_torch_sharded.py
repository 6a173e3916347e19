"""The port's sharded round engine (``engine="sharded"``) and its mesh
(``repro_torch.sharding``) against the JAX package's, and against the port's
own vmap engine.

On the CPU ``client_mesh(n, device="cpu")`` gives n logical shards of the
CPU in one process, so meshes of 1, 2 and 4 run here; the JAX package's
tests pin one CPU device, so its sharded engine runs on a 1-device mesh
(``tests/test_sharded.py``). Setup as ``test_torch_engine.py``: its ``TINY``
llava config and 3 clients, the JAX-drawn server exported through
``repro_torch.interop``, both packages' data.

Tolerances relative to the reference's ∞-norm: against the live JAX sharded
run, round losses and the adapters at 1e-5; the port's sharded engine
against its vmap engine at 1e-6 (the same per-client arithmetic; the merge
folds stacks where the vmap engine merges uploads one by one, another f32
order). Comm totals, counts and participants exactly; overlap on against
off and padding rows against none to the bit.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import HyperParams as JHyperParams
from repro.core import run_federated as jax_run_federated
from repro.core.comm import CommLog as JCommLog
from repro.sharding import pad_to_multiple as jax_pad_to_multiple
from repro.strategies import FixedSizeSampler as JFixedSizeSampler
from repro.strategies import get_strategy as jax_get_strategy
from repro_torch import interop
from repro_torch.core import HyperParams
from repro_torch.core import client as client_lib
from repro_torch.data import make_federated_data
from repro_torch.launch import train
from repro_torch.sharding import (CLIENT_AXIS, ClientMesh, Sharded, client_mesh,
                                  pad_to_multiple, shard)
from repro_torch.strategies import get_strategy
from repro_torch.utils import tree_leaves, tree_map

from test_torch_checkpoint import TINY_DATA
from test_torch_engine import (CIDS, HP, ROUNDS, _port_run, _port_server, _Replay, _tiny,
                               assert_run_matches)
from test_torch_resume import assert_equivalent
from test_torch_training import assert_tree_close, one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
# The clients' adapters after round 1, sharded against vmap: the stacked merge
# sums Σ wθ by a tensordot over each chunk where the vmap engine merges the
# uploads one by one (another f32 order; the global adapters part by at most
# 7.7e-7), and round 1's AdamW steps grow that to 1.96e-6 under FedAvg (CPU,
# this file's setup). Every other observable is held at 1e-6 or exactly.
CLIENT_TOL = 5e-6


def _sharded(strategy="fednano", devices=1, **kw):
    return _port_run(strategy, engine="sharded", devices=devices, **kw)


def _bits_equal(a, b, what=""):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb), what
    for x, y in zip(la, lb):
        assert torch.equal(x, y), what


def _runs_bit_equal(a, b, what=""):
    assert a.round_metrics == b.round_metrics, what
    assert a.comm_totals == b.comm_totals, what
    _bits_equal(a.server.global_adapters, b.server.global_adapters, what)
    for ca, cb in zip(a.clients, b.clients):
        _bits_equal(ca.adapters, cb.adapters, what)
        _bits_equal(ca.opt_state, cb.opt_state, what)
        _bits_equal(ca.fisher, cb.fisher, what)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def test_client_mesh_shape():
    mesh = client_mesh(device="cpu")
    assert mesh.axis_names == (CLIENT_AXIS,) and mesh.size == 1
    mesh = client_mesh(4, device="cpu")
    assert mesh.size == 4 and mesh.devices == (CPU,) * 4 and mesh.distinct == [CPU]
    assert ClientMesh(["cpu", "cpu"]) == client_mesh(2, "cpu")
    with pytest.raises(ValueError, match=">= 1 device"):
        client_mesh(0, device="cpu")


def test_client_mesh_too_many_devices():
    """More cards than are visible raises, as the JAX package does (here: no
    card at all, so even one is too many)."""
    with pytest.raises(ValueError, match=f"only {torch.cuda.device_count()} cuda devices"):
        client_mesh(torch.cuda.device_count() + 1)


@pytest.mark.parametrize("n,m", [(5, 8), (8, 8), (9, 8), (0, 8), (3, 1), (7, 2)])
def test_pad_to_multiple_matches_reference(n, m):
    assert pad_to_multiple(n, m) == jax_pad_to_multiple(n, m)


def test_pad_to_multiple_rejects_a_zero_multiple():
    for fn in (pad_to_multiple, jax_pad_to_multiple):
        with pytest.raises(ValueError):
            fn(3, 0)


def test_shard_rows_and_gather():
    """A stacked tree cut into row blocks gives back its rows in order."""
    tree = {"a": torch.arange(12.0).reshape(6, 2), "b": torch.arange(6)}
    s = shard(tree, client_mesh(3, "cpu"))
    assert isinstance(s, Sharded) and s.width == 6 and s.block_width == 2
    assert [int(r["b"]) for r in s.rows(5)] == [0, 1, 2, 3, 4]
    assert torch.equal(s.gather(4)["a"], tree["a"][:4])
    assert s.row_bytes() == 2 * 4 + 8


# ---------------------------------------------------------------------------
# against the JAX package's sharded engine (its 1-device mesh)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", ["fednano", "fedavg"])
def test_sharded_matches_reference(strategy):
    jcfg, jsrv, (jtrain, jeval, _), *_ = _tiny()
    want = jax_run_federated(jax.random.PRNGKey(0), jcfg, jtrain, jeval, strategy=strategy,
                             rounds=ROUNDS, hp=JHyperParams(**HP),
                             server=dataclasses.replace(jsrv, comm=JCommLog()),
                             engine="sharded")
    got = _sharded(strategy)
    assert got.engine == "sharded"
    assert_run_matches(got, want, f"sharded {strategy}", loss_tol=1e-5, adapter_tol=1e-5)
    assert got.client_accuracy == want.client_accuracy


# ---------------------------------------------------------------------------
# against the port's vmap engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("devices", [1, 2, 4])
@pytest.mark.parametrize("strategy", ["fednano", "fedavg", "fednano_ef"])
def test_sharded_matches_vmap(strategy, devices):
    """Meshes of 1, 2 and 4 logical CPU shards: 3 chunks of 1 client, chunks
    of 2 (the last padded), one chunk of 3 padded to 4. Losses and the global
    adapters at 1e-6 of the vmap run's; the clients' adapters after round 1
    at CLIENT_TOL; meshes of 2 and 4 equal the mesh of 1 to the bit."""
    got = _sharded(strategy, devices)
    assert_run_matches(got, _port_run(strategy), f"mesh {devices}", loss_tol=1e-6,
                       adapter_tol=CLIENT_TOL)
    assert_tree_close(got.server.global_adapters,
                      interop.adapters_to_numpy(_port_run(strategy).server.global_adapters),
                      1e-6, f"mesh {devices} global")
    if devices > 1:
        _runs_bit_equal(got, _sharded(strategy, 1), f"mesh {devices} vs 1")


@pytest.mark.parametrize("strategy,kw", [
    ("feddpa_f", {}), ("fednano", dict(use_pallas=True)),
    ("fednano", dict(use_pallas=True, agg_chunk=2)), ("fedavg", dict(use_pallas=True))],
    ids=["feddpa_f", "fednano-kernels", "fednano-kernels-chunk2", "fedavg-kernels"])
def test_sharded_per_client_path_equals_vmap(strategy, kw):
    """Where the stacked merge does not apply (personal adapters; use_pallas,
    whose Fisher kernels merge or fold the uploads client by client), the
    uploads are offered one by one as the vmap engine offers them: the run
    equals the vmap run to the bit (each client's arithmetic does not depend
    on the rows it shares a pass with, on the CPU)."""
    _runs_bit_equal(_sharded(strategy, 2, **kw), _port_run(strategy, **kw), f"{strategy} {kw}")


@pytest.mark.parametrize("strategy", ["fednano", "feddpa_f"])
def test_overlap_off_is_bit_identical(strategy):
    """The pipeline changes when a chunk is collected, never what is computed
    or the order the merge sees."""
    _runs_bit_equal(_sharded(strategy, 2), _sharded(strategy, 2, overlap=False), strategy)


def test_sampled_cohorts_materialize_resident_rows():
    """A sampler changes the cohort every round, so chunks are reshuffled and
    the resident rows go back to their clients before stacking; equal to the
    vmap engine under the same cohorts."""
    sampler = _Replay(jax_sampler=JFixedSizeSampler(n=2, seed=11))
    got = _sharded("fednano", 2, sampler=sampler, rounds=4)
    assert_run_matches(got, _port_run("fednano", sampler=sampler, rounds=4), "sampled",
                       loss_tol=1e-6, adapter_tol=1e-6)


# ---------------------------------------------------------------------------
# padding rows
# ---------------------------------------------------------------------------

def _states(strategy, cids):
    cfg = _tiny()[3]
    strat = get_strategy(strategy)
    return [strat.init_client(torch.Generator().manual_seed(c), cfg, c, 4) for c in cids]


@pytest.mark.parametrize("k,devices,pad_to", [(3, 1, 4), (5, 2, None)])
def test_padding_rows_are_inert(k, devices, pad_to):
    """K = 3 padded to 4 on a mesh of 1, K = 5 on a mesh of 2 (padded to 6):
    the real clients' states and metrics equal an unpadded run's, to the bit;
    the padding rows never come back."""
    cfg = _tiny()[3]
    train_b, _, _ = make_federated_data(cfg, device="cpu", **dict(TINY_DATA, n_clients=k))
    server = _port_server()
    states = _states("fednano", range(k))
    blists = [train_b[c] for c in range(k)]
    hp = HyperParams(**HP)
    plain, pm = client_lib.local_update_many(cfg, server.backbone, states, blists, hp, "fednano",
                                             server.global_adapters,
                                             mesh=client_mesh(devices, "cpu"), pad_to=k
                                             if devices == 1 else None)
    padded, qm = client_lib.local_update_many(cfg, server.backbone, states, blists, hp,
                                              "fednano", server.global_adapters,
                                              mesh=client_mesh(devices, "cpu"), pad_to=pad_to)
    if devices > 1:  # the reference: the vmap engine's one unpadded cohort
        plain, pm = client_lib.local_update_many(cfg, server.backbone, states, blists, hp,
                                                 "fednano", server.global_adapters)
    assert len(padded) == len(plain) == k and pm == qm
    for a, b in zip(plain, padded):
        _bits_equal(a.adapters, b.adapters)
        _bits_equal(a.fisher, b.fisher)
        _bits_equal(a.opt_state, b.opt_state)
        assert a.rounds_participated == b.rounds_participated == 1


def test_pad_to_validation():
    *_, cfg, _, _, (train_b, _, _) = _tiny()
    states = _states("fedavg", CIDS)
    hp = HyperParams(**HP)
    with pytest.raises(ValueError, match="smaller than the cohort"):
        client_lib.prepare_cohort(cfg, states, [train_b[c] for c in CIDS], hp, "fedavg",
                                  mesh=client_mesh(1, "cpu"), pad_to=2)
    with pytest.raises(ValueError, match="multiple of the mesh size 2"):
        client_lib.prepare_cohort(cfg, states, [train_b[c] for c in CIDS], hp, "fedavg",
                                  mesh=client_mesh(2, "cpu"), pad_to=5)


@pytest.mark.parametrize("strategy", ["fednano", "fedavg"])
def test_zero_weight_rows_inert_in_stacked_fold(strategy):
    """agg_stream_fold_stacked over two chunks, one with a zero-weight padding
    row, plain and cut over a mesh of 2: against the JAX package's fold of
    the same stacks, and the zero-weight row adds nothing."""
    rng = np.random.default_rng(7)
    shapes = {"text": {"down": (8, 4), "up": (4, 8)}}

    def stack(k, positive=False):
        draw = lambda s: np.abs(rng.standard_normal(s)) + 0.1 if positive else rng.standard_normal(s)
        return {m: {n: draw((k, *s)).astype(np.float32) for n, s in d.items()}
                for m, d in shapes.items()}

    thetas, fishers = [stack(3), stack(2)], [stack(3, True), stack(2, True)]
    weights = [[2.0, 1.0, 3.0], [4.0, 0.0]]  # the second chunk's last row is padding
    jstrat, strat = jax_get_strategy(strategy), get_strategy(strategy)
    jfin = jstrat.agg_stream_finalize(jstrat.agg_stream_fold_stacked(
        None, [jax.tree.map(jax.numpy.asarray, t) for t in thetas],
        [jax.tree.map(jax.numpy.asarray, f) for f in fishers], weights))
    to_t = lambda tree: tree_map(torch.from_numpy, tree)
    pt, pf = [to_t(t) for t in thetas], [to_t(f) for f in fishers]
    mesh = client_mesh(2, "cpu")
    unpadded = [pt[0], tree_map(lambda x: x[:1], pt[1])]
    unpadded_f = [pf[0], tree_map(lambda x: x[:1], pf[1])]
    for label, ts, fs, ws in (
            ("plain", pt, pf, weights),
            ("mesh of 2", [pt[0], shard(pt[1], mesh)], [pf[0], shard(pf[1], mesh)], weights),
            ("unpadded", unpadded, unpadded_f, [weights[0], weights[1][:1]])):
        acc = strat.agg_stream_fold_stacked(None, ts, fs, ws)
        assert acc["w"] == 10.0
        got = strat.agg_stream_finalize(acc)
        for g, w in zip(tree_leaves(got), jax.tree.leaves(jfin)):
            w = np.asarray(w)
            assert float(np.abs(g.numpy() - w).max()) <= 1e-6 * float(np.abs(w).max()), label
    padded = strat.agg_stream_fold_stacked(None, [pt[1]], [pf[1]], [weights[1]])
    plain = strat.agg_stream_fold_stacked(None, [unpadded[1]], [unpadded_f[1]],
                                          [weights[1][:1]])
    _bits_equal(padded["num"], plain["num"], "zero-weight row")


# ---------------------------------------------------------------------------
# resume, arguments, the CLI
# ---------------------------------------------------------------------------

def test_sharded_checkpoint_resume(tmp_path):
    """Cut after round 1 and resumed: equal to the uninterrupted run (the
    snapshot materializes the resident rows first)."""
    d = str(tmp_path / "state")
    full = _sharded("fednano", 2, rounds=3)
    _sharded("fednano", 2, rounds=1, checkpoint_dir=d, checkpoint_every=1, final_eval=False)
    resumed = _sharded("fednano", 2, rounds=3, resume=d)
    assert_equivalent(full, resumed)
    for cf, cr in zip(full.clients, resumed.clients):
        _bits_equal(cf.opt_state, cr.opt_state)


def test_devices_rejected_on_other_engines():
    with pytest.raises(ValueError, match="devices= only applies"):
        _port_run("fednano", engine="vmap", devices=1)


def test_train_cli_sharded_on_cpu(tmp_path, capsys):
    args = ["--device", "cpu", "--engine", "sharded", "--devices", "2", "--no-overlap",
            "--clients", "3", "--rounds", "2", "--local-steps", "2",
            "--examples-per-client", "8", "--alpha", "100", "--batch-size", "2",
            "--seq-len", "8", "--out", str(tmp_path)]
    assert train.main(args) == 0
    assert "round 1" in capsys.readouterr().out
