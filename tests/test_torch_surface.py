"""The port's public surface against the JAX package's, on the CPU.

* Every name of ``__all__`` in the JAX package's subpackages resolves in the
  port's counterpart and stands in its ``__all__``, but for the names listed
  in ``NO_COUNTERPART`` with the reason each has none.
* The small pieces of that surface, held against the JAX functions on equal
  numpy inputs: SGD (5 steps, with and without momentum) and the tree
  helpers in f32 at 1e-6 of ‖ref‖∞; the schedules within 1e-7;
  ``make_optimizer``; ``fmt_params`` and ``fmt_bytes`` letter for letter;
  ``adapter_param_count`` and ``fisher_size_bytes`` exactly; ``dp_sigma`` to
  1e-12; ``aggregate`` for every strategy name at 1e-6; ``fisher_finalize``
  after ``fisher_fold``; ``apply_update``.
* ``Strategy.init_clients`` and ``client.init_clients_batched`` give the
  per-client loop's clients bit for bit.
* The vision stubs: shapes, dtypes, seed determinism and the topic identity
  both packages share (their random draws differ).
* ``dryrun --all`` writes the records of every arch and shape.
"""
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import adapters as jnano
from repro.core import aggregation as jagg
from repro.core import compression as jcompression
from repro.core import fisher as jfisher
from repro.core import privacy as jprivacy
from repro.kernels.fisher_merge import ref as jfm_ref
from repro.models import vision_stub as jvision
from repro.optim import schedules as jschedules
from repro.optim import sgd as jsgd
from repro.utils import tree as jtree
from repro_torch import interop
from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config, get_smoke_config
from repro_torch.core import adapters as nano
from repro_torch.core import aggregation, client as client_lib, compression, fisher, privacy
from repro_torch.kernels.fisher_merge import ref as fm_ref
from repro_torch.launch import dryrun
from repro_torch.models import vision_stub
from repro_torch.optim import adamw_update, make_optimizer, schedules, sgd
from repro_torch.strategies import base as strategies_base
from repro_torch.strategies import get_strategy
from repro_torch.utils import tree as ttree
from repro_torch.utils import tree_leaves

from test_torch_training import one_torch_thread, rel_err  # noqa: F401

PACKAGES = ["checkpoint", "configs", "core", "data", "kernels", "models", "optim", "serving",
            "strategies", "utils"]
# JAX names the port leaves out, each with the reason.
NO_COUNTERPART = {
    ("repro.strategies", "round_key"): "folds a round index into a jax.random key; the port's "
                                       "samplers draw from seeded numpy generators",
    ("repro.sharding", "constrain"): "an XLA sharding hint; the port runs one process and "
                                     "shards no model axis",
    ("repro.sharding", "use_mesh"): "sets the mesh XLA's hints read",
    ("repro.sharding", "current_mesh"): "reads the mesh XLA's hints read",
    ("repro.sharding", "named_sharding"): "builds an XLA NamedSharding",
    ("repro.sharding", "residual_spec"): "places the residual stream for XLA",
    ("repro.launch.dryrun", "build_lowerable"): "builds an XLA lowering",
    ("repro.launch.dryrun", "run_pair"): "compiles a pair on a TPU mesh; the port's run_fit "
                                         "gives the analytic per-card footprint",
    ("repro.launch.mesh", "make_production_mesh"): "a TPU pod mesh",
    ("repro.launch.mesh", "make_debug_mesh"): "a forced-CPU-device XLA mesh",
    ("repro.launch.roofline", "collective_bytes_from_hlo"): "reads an optimized HLO, which the "
                                                            "port does not have",
}
TREE_SHAPES = {"text": {"down": (16, 4), "up": (4, 16)}, "image": {"down": (16, 4),
                                                                   "up": (4, 16)}}


def draw(rng, scale=1.0, shapes=TREE_SHAPES):
    return {m: {n: (rng.standard_normal(sh) * scale).astype(np.float32) for n, sh in d.items()}
            for m, d in shapes.items()}


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_port(tree):
    return interop.adapters_from_numpy(tree, "cpu")


def assert_tree_close(got, want, tol):
    got = interop.adapters_to_numpy(got)
    want = jax.tree.map(np.asarray, want)
    assert sorted(got) == sorted(want)
    for m in want:
        for n in want[m]:
            assert rel_err(got[m][n], want[m][n]) <= tol, (m, n)


# ---------------------------------------------------------------------------
# names
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("package", PACKAGES)
def test_public_names_resolve_in_the_port(package):
    jmod = importlib.import_module(f"repro.{package}")
    tmod = importlib.import_module(f"repro_torch.{package}")
    for name in jmod.__all__:
        if (jmod.__name__, name) in NO_COUNTERPART:
            assert not hasattr(tmod, name), name
            continue
        assert hasattr(tmod, name), f"repro_torch.{package} lacks {name}"
        assert name in tmod.__all__, f"repro_torch.{package}.__all__ lacks {name}"


@pytest.mark.parametrize("module,name", sorted(NO_COUNTERPART))
def test_names_without_counterpart_are_listed_with_a_reason(module, name):
    assert NO_COUNTERPART[(module, name)]
    assert hasattr(importlib.import_module(module), name)
    port = importlib.import_module(module.replace("repro", "repro_torch", 1))
    assert not hasattr(port, name)


# ---------------------------------------------------------------------------
# optim
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("momentum", [0.0, 0.9], ids=["plain", "momentum"])
def test_sgd_matches_reference(momentum):
    rng = np.random.default_rng(3)
    params = draw(rng)
    jp, js = to_jax(params), jsgd.sgd_init(to_jax(params))
    tp, ts = to_port(params), sgd.sgd_init(to_port(params))
    for _ in range(5):
        grads = draw(rng, 0.5)
        jp, js = jsgd.sgd_update(to_jax(grads), js, jp, lr=0.05, momentum=momentum)
        tp, ts = sgd.sgd_update(to_port(grads), ts, tp, lr=0.05, momentum=momentum)
    assert_tree_close(tp, jp, 1e-6)
    assert_tree_close(ts.velocity, js.velocity, 1e-6)
    if not momentum:  # the velocity stays the initial zeros
        assert all(not bool(t.any()) for t in tree_leaves(ts.velocity))


def test_sgd_keeps_each_parameter_dtype():
    params = {"a": torch.ones(3, dtype=torch.bfloat16), "b": torch.ones(2)}
    grads = {"a": torch.full((3,), 0.5), "b": torch.full((2,), 0.5)}
    new, _ = sgd.sgd_update(grads, sgd.sgd_init(params), params, lr=0.1, momentum=0.5)
    assert new["a"].dtype == torch.bfloat16 and new["b"].dtype == torch.float32


# (name, args, the last step past which the schedule is flat)
SCHEDULES = [("constant_schedule", (0.1,), 10), ("cosine_schedule", (0.1, 10), 10),
             ("cosine_schedule", (0.1, 10, 0.25), 10), ("cosine_schedule", (0.1, 0), 1),
             ("linear_warmup_cosine", (0.1, 3, 10), 10),
             ("linear_warmup_cosine", (0.1, 0, 10), 10),
             ("linear_warmup_cosine", (0.1, 4, 4, 0.0), 5)]


@pytest.mark.parametrize("name,args,total", SCHEDULES,
                         ids=[f"{n}{a}" for n, a, _ in SCHEDULES])
@pytest.mark.parametrize("kind", ["int", "tensor"])
def test_schedules_match_reference(name, args, total, kind):
    """Steps 0 to total + 2: the warmup's boundary, the cosine's end and the
    clip past it."""
    jf, tf = getattr(jschedules, name)(*args), getattr(schedules, name)(*args)
    for step in range(total + 3):
        js = step if kind == "int" else jnp.int32(step)
        ts = step if kind == "int" else torch.tensor(step, dtype=torch.int32)
        want, got = np.asarray(jf(js)), tf(ts)
        assert got.dtype == torch.float32 and got.shape == () and want.dtype == np.float32
        assert abs(float(got) - float(want)) <= 1e-7, (step, float(got), float(want))


def test_warmup_boundary():
    f = schedules.linear_warmup_cosine(0.1, 4, 12)
    assert float(f(3)) == pytest.approx(0.075, abs=1e-7)  # 3/4 of the way up
    assert float(f(4)) == pytest.approx(0.1, abs=1e-7)    # the cosine's step 0
    assert float(f(12)) == pytest.approx(0.01, abs=1e-7)  # final_frac of lr
    assert float(f(20)) == pytest.approx(0.01, abs=1e-7)  # clipped past the end


def test_make_optimizer():
    rng = np.random.default_rng(4)
    params, grads = to_port(draw(rng)), to_port(draw(rng))
    init, update = make_optimizer("sgd", momentum=0.9)
    got, _ = update(grads, init(params), params, 0.1)
    want, _ = sgd.sgd_update(grads, sgd.sgd_init(params), params, lr=0.1, momentum=0.9)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want)))
    init, update = make_optimizer("adamw", weight_decay=0.01)
    state = init(params)
    got, new_state = update(grads, state, params, 0.01)
    want, _ = adamw_update(grads, state, params, lr=0.01, weight_decay=0.01)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want)))
    assert int(new_state.step) == 1
    with pytest.raises(ValueError, match="unknown optimizer 'lion'"):
        make_optimizer("lion")


# ---------------------------------------------------------------------------
# utils
# ---------------------------------------------------------------------------

def test_tree_helpers_match_reference():
    rng = np.random.default_rng(5)
    a, b = draw(rng), draw(rng)
    want = jtree.tree_dot(to_jax(a), to_jax(b))
    got = ttree.tree_dot(to_port(a), to_port(b))
    assert got.dtype == torch.float32 and got.shape == ()
    assert rel_err(got, want) <= 1e-6
    assert rel_err(ttree.tree_sq_norm(to_port(a)), jtree.tree_sq_norm(to_jax(a))) <= 1e-6
    assert float(ttree.tree_dot({}, {})) == 0.0
    assert_tree_close(ttree.tree_scale(to_port(a), 0.3), jtree.tree_scale(to_jax(a), 0.3), 1e-6)
    cast = ttree.tree_cast(to_port(a), torch.bfloat16)
    jcast = jtree.tree_cast(to_jax(a), jnp.bfloat16)
    for g, w in zip(tree_leaves(cast), jax.tree.leaves(jcast)):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))


@pytest.mark.parametrize("shift,rtol,atol", [(0.0, 1e-5, 1e-6), (5e-6, 1e-5, 1e-6),
                                             (5e-4, 1e-5, 1e-6), (5e-4, 1e-3, 1e-6),
                                             (5e-4, 0.0, 1e-3)])
def test_tree_allclose_matches_reference(shift, rtol, atol):
    rng = np.random.default_rng(6)
    a = draw(rng)
    b = jax.tree.map(lambda x: x + np.float32(shift), a)
    want = jtree.tree_allclose(to_jax(a), to_jax(b), rtol=rtol, atol=atol)
    assert ttree.tree_allclose(to_port(a), to_port(b), rtol=rtol, atol=atol) == want
    assert ttree.tree_allclose(to_port(a), to_port(b)) == jtree.tree_allclose(to_jax(a),
                                                                           to_jax(b))
    # bf16 leaves, which numpy cannot hold, are compared widened
    half = ttree.tree_cast(to_port(a), torch.bfloat16)
    assert ttree.tree_allclose(half, half)


@pytest.mark.parametrize("n", [0, 999, 1000, 1023, 1024, 10**6 - 1, 10**9, 2**50])
def test_formatting_letter_for_letter(n):
    assert ttree.fmt_params(n) == jtree.fmt_params(n)
    assert ttree.fmt_bytes(n) == jtree.fmt_bytes(n)


# ---------------------------------------------------------------------------
# core
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ASSIGNED_ARCHS + ["llava-1.5-7b", "minigpt4-7b"])
def test_adapter_param_count(arch):
    for port_cfg, jax_cfg in ((get_config(arch), jax_get_config(arch)),
                              (get_smoke_config(arch), jax_smoke_config(arch))):
        got = nano.adapter_param_count(port_cfg)
        assert got == jnano.adapter_param_count(jax_cfg)
        drawn = nano.init_nanoedge(torch.Generator().manual_seed(0), port_cfg) \
            if port_cfg.d_model <= 1024 else None
        if drawn is not None:
            assert got == sum(t.numel() for t in tree_leaves(drawn))


def test_fisher_size_bytes():
    rng = np.random.default_rng(7)
    f = draw(rng, shapes={"text": {"down": (16, 4), "up": (4, 16)}, "image": {"down": (8, 3)}})
    tf = to_port(f)
    tf["image"]["down"] = tf["image"]["down"].to(torch.bfloat16)
    f["image"]["down"] = np.asarray(jnp.asarray(f["image"]["down"], jnp.bfloat16))
    assert fisher.fisher_size_bytes(tf) == jfisher.fisher_size_bytes(f) == 4 * 128 + 2 * 24


@pytest.mark.parametrize("epsilon,delta", [(1.0, 1e-5), (0.5, 1e-6), (8.0, 1e-3), (1e-3, 0.1)])
def test_dp_sigma(epsilon, delta):
    got, want = privacy.dp_sigma(epsilon, delta), jprivacy.dp_sigma(epsilon, delta)
    assert isinstance(got, float) and abs(got - want) <= 1e-12 * abs(want)


@pytest.mark.parametrize("epsilon", [0.0, -1.0])
def test_dp_sigma_rejects_nonpositive_epsilon(epsilon):
    with pytest.raises(ValueError, match="epsilon must be > 0"):
        privacy.dp_sigma(epsilon, 1e-5)
    with pytest.raises(ValueError, match="epsilon must be > 0"):
        jprivacy.dp_sigma(epsilon, 1e-5)


def _uploads(k=3, seed=8):
    rng = np.random.default_rng(seed)
    thetas = [draw(rng) for _ in range(k)]
    fishers = [jax.tree.map(lambda x: np.abs(x) + np.float32(0.01), draw(rng)) for _ in range(k)]
    return thetas, fishers, [7, 3, 12][:k]


def test_strategies_tuple_matches_reference():
    assert aggregation.STRATEGIES == jagg.STRATEGIES


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("strategy", list(jagg.STRATEGIES))
def test_aggregate_matches_reference(strategy, use_pallas):
    thetas, fishers, sizes = _uploads()
    want = jagg.aggregate(strategy, [to_jax(t) for t in thetas], [to_jax(f) for f in fishers],
                          sizes, use_pallas=use_pallas)
    got = aggregation.aggregate(strategy, [to_port(t) for t in thetas],
                                [to_port(f) for f in fishers], sizes, use_pallas=use_pallas)
    if strategy == "locft":
        assert got is None and want is None
        return
    assert_tree_close(got, want, 1e-6)


def test_aggregate_rejects_unknown_names():
    thetas, fishers, sizes = _uploads()
    for name in ("fedadam", "FedNano", ""):
        with pytest.raises(ValueError, match="unknown strategy"):
            aggregation.aggregate(name, [to_port(t) for t in thetas],
                                  [to_port(f) for f in fishers], sizes)
        with pytest.raises(ValueError, match="unknown strategy"):
            jagg.aggregate(name, [to_jax(t) for t in thetas], [to_jax(f) for f in fishers],
                           sizes)


def test_fisher_finalize_after_fold_matches_merge():
    rng = np.random.default_rng(9)
    k, n = 4, 1000
    theta = rng.standard_normal((k, n)).astype(np.float32)
    fis = (np.abs(rng.standard_normal((k, n))) + 0.01).astype(np.float32)
    w = np.asarray([0.1, 0.2, 0.3, 0.4], np.float32)
    num, den = torch.zeros(n), torch.zeros(n)
    jnum, jden = jnp.zeros(n), jnp.zeros(n)
    for i in range(k):
        fm_ref.fisher_fold(num, den, torch.from_numpy(theta[i]), torch.from_numpy(fis[i]),
                           float(w[i]))
        jnum, jden = jfm_ref.fisher_fold(jnum, jden, theta[i], fis[i], float(w[i]))
    got = fm_ref.fisher_finalize(num, den)
    assert got.dtype == torch.float32
    assert rel_err(got, jfm_ref.fisher_finalize(jnum, jden)) <= 1e-6
    assert rel_err(got, jfm_ref.fisher_merge(theta, fis, w)) <= 1e-6
    assert rel_err(got, fm_ref.fisher_merge(torch.from_numpy(theta), torch.from_numpy(fis),
                                            w)) <= 1e-6
    half = fm_ref.fisher_finalize(num, den, eps=1e-3, dtype=torch.bfloat16)
    want = jfm_ref.fisher_finalize(jnum, jden, eps=1e-3, dtype=jnp.bfloat16)
    assert half.dtype == torch.bfloat16
    np.testing.assert_array_equal(half.float().numpy(), np.asarray(want, np.float32))


def test_apply_update_matches_reference():
    rng = np.random.default_rng(10)
    ref, delta = draw(rng), draw(rng, 0.01)
    tref = to_port(ref)
    tref["image"]["up"] = tref["image"]["up"].to(torch.bfloat16)
    jref = to_jax(ref)
    jref["image"]["up"] = jref["image"]["up"].astype(jnp.bfloat16)
    got = compression.apply_update(tref, to_port(delta))
    want = jcompression.apply_update(jref, to_jax(delta))
    assert got["image"]["up"].dtype == torch.bfloat16
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))


# ---------------------------------------------------------------------------
# clients
# ---------------------------------------------------------------------------

def _same_client(a, b):
    assert (a.cid, a.n_examples, a.rounds_participated) == (b.cid, b.n_examples,
                                                            b.rounds_participated)
    for x, y in ((a.adapters, b.adapters), (a.opt_state, b.opt_state),
                 (a.local_adapters, b.local_adapters)):
        lx, ly = tree_leaves(x), tree_leaves(y)
        assert len(lx) == len(ly)
        assert all(p.dtype == q.dtype and torch.equal(p, q) for p, q in zip(lx, ly))


@pytest.mark.parametrize("strategy", ["fednano", "feddpa_f", "locft"])
def test_init_clients_equals_the_per_client_loop(strategy):
    cfg = get_smoke_config("llava-1.5-7b")
    strat = get_strategy(strategy)
    cids, sizes = [3, 5, 8, 9], [16, 4, 9, 1]
    got = strat.init_clients(torch.Generator().manual_seed(11), cfg, cids, sizes)
    gen = torch.Generator().manual_seed(11)
    want = [strat.init_client(gen, cfg, c, n) for c, n in zip(cids, sizes)]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _same_client(a, b)
    assert (got[0].local_adapters is not None) == (strategy == "feddpa_f")
    batched = client_lib.init_clients_batched(strat, torch.Generator().manual_seed(11), cfg,
                                              cids, sizes)
    for a, b in zip(batched, want):
        _same_client(a, b)
    one = client_lib.init_client(torch.Generator().manual_seed(11), cfg, 3, 16, strategy)
    _same_client(one, want[0])


def test_init_clients_falls_back_to_an_overridden_init_client():
    calls = []

    class Counted(type(get_strategy("fedavg"))):
        def init_client(self, gen, cfg, cid, n_examples):
            calls.append(cid)
            return super().init_client(gen, cfg, cid, n_examples)

    cfg = get_smoke_config("llava-1.5-7b")
    got = Counted().init_clients(torch.Generator().manual_seed(1), cfg, [0, 1, 2], [4, 4, 4])
    assert calls == [0, 1, 2] and [c.cid for c in got] == [0, 1, 2]
    with pytest.raises(ValueError, match="3 cids but 2 sizes"):
        client_lib.init_clients_batched(get_strategy("fednano"),
                                        torch.Generator().manual_seed(1), cfg, [0, 1, 2], [4, 4])


def test_init_clients_is_the_base_hook():
    assert strategies_base.Strategy.init_clients is get_strategy("fednano_ef").init_clients.__func__


# ---------------------------------------------------------------------------
# vision stubs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llava-1.5-7b", "minigpt4-7b", "whisper-base",
                                  "qwen2-vl-72b"])
def test_vision_stub_shapes_match_reference(arch):
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = vision_stub.patch_embeddings(torch.Generator().manual_seed(0), cfg, 3, dtype)
        want = jvision.patch_embeddings(jax.random.PRNGKey(0), jcfg, 3, jdtype)
        assert tuple(got.shape) == want.shape and got.dtype == dtype
        vecs = torch.ones((3, cfg.frontend_dim))
        got = vision_stub.topic_patch_embeddings(torch.Generator().manual_seed(0), cfg, vecs,
                                                 dtype)
        want = jvision.topic_patch_embeddings(jax.random.PRNGKey(0), jcfg, jnp.ones(
            (3, jcfg.frontend_dim)), jdtype)
        assert tuple(got.shape) == want.shape and got.dtype == dtype


def test_vision_stub_draws_are_seeded_and_share_the_topic_identity():
    cfg = get_smoke_config("llava-1.5-7b")
    patch = lambda seed: vision_stub.patch_embeddings(torch.Generator().manual_seed(seed), cfg, 4)
    assert torch.equal(patch(1), patch(1)) and not torch.equal(patch(1), patch(2))
    vecs = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (4, cfg.frontend_dim)).astype(np.float32))
    topic = vision_stub.topic_patch_embeddings(torch.Generator().manual_seed(1), cfg, vecs)
    # topic − topic_vecs = 0.5 · patch, to the rounding of the sum
    assert rel_err(topic - vecs[:, None, :], (0.5 * patch(1)).numpy()) <= 1e-6
    zero = vision_stub.topic_patch_embeddings(torch.Generator().manual_seed(1), cfg,
                                              torch.zeros_like(vecs))
    assert torch.equal(zero, 0.5 * patch(1))
    # the same identity in the JAX package
    jcfg = jax_smoke_config("llava-1.5-7b")
    jvecs = jnp.asarray(vecs.numpy())
    jtopic = jvision.topic_patch_embeddings(jax.random.PRNGKey(1), jcfg, jvecs)
    jpatch = jvision.patch_embeddings(jax.random.PRNGKey(1), jcfg, 4)
    assert rel_err(np.asarray(jtopic - jvecs[:, None, :]),
                   np.asarray(0.5 * jpatch)) <= 1e-6


def test_vision_stub_draws_on_the_generator_device():
    cfg = get_smoke_config("llava-1.5-7b")
    t = vision_stub.patch_embeddings(torch.Generator(device="cpu").manual_seed(0), cfg, 2)
    assert t.device.type == "cpu"


# ---------------------------------------------------------------------------
# dry-run
# ---------------------------------------------------------------------------

def _records(path):
    out = {}
    for f in sorted(path.iterdir()):
        rec = json.loads(f.read_text())
        rec.pop("wall_s", None)
        out[f.name] = rec
    return out


def test_dryrun_all_writes_every_arch_and_shape(tmp_path, monkeypatch):
    """``--all --mode roofline`` against one call per arch and shape. Each
    distinct report is counted once (the second sweep takes the first's
    report for the same arguments), so the test stays short while every
    record of both sweeps is written by ``run_roofline``."""
    seen = {}
    real = dryrun.roofline_report

    def once(arch, cfg0, shape_cfg, layout_name, overrides=None):
        key = (arch, shape_cfg.name, layout_name, json.dumps(overrides, sort_keys=True))
        if key not in seen:
            seen[key] = real(arch, cfg0, shape_cfg, layout_name, overrides)
        return seen[key]

    monkeypatch.setattr(dryrun, "roofline_report", once)
    assert dryrun.main(["--all", "--mode", "roofline", "--out", str(tmp_path / "all")]) == 0
    n_reports = len(seen)
    for arch in ASSIGNED_ARCHS:
        for shape in INPUT_SHAPES:
            assert dryrun.main(["--arch", arch, "--shape", shape, "--mode", "roofline",
                                "--out", str(tmp_path / "each")]) == 0
    assert len(seen) == n_reports  # the listing asked for no report --all did not
    every, each = _records(tmp_path / "all"), _records(tmp_path / "each")
    assert len(every) == len(ASSIGNED_ARCHS) * len(INPUT_SHAPES)
    assert every == each
    assert {r["status"] for r in every.values()} <= {"ok", "skip"}
