"""The port's upload transforms, compression, DP, server optimizers, FedAvg
mean and client samplers against the JAX package.

On identical inputs (numpy draws from a seed, shaped like an adapter tree)
the int8 quantizer with error feedback and top-k sparsification agree with
the JAX transforms bit for bit: payload, scales, indices (as a set: the
two packages may order the kept entries differently; among equal
magnitudes both keep the lower index), values, residual, the θ the server
decodes and the wire bytes. Their arithmetic is a max, an IEEE division,
round half to even, a clip, an index selection and a subtraction, so
nothing depends on summation order.

The DP clip scales by C / ‖δ‖₂, and ‖δ‖₂ is a sum whose order differs
between XLA and torch: the clip is held bit for bit where it is inactive
and, where it is active, to ``CLIP_TOL`` (the JAX package's own
``tree_sq_norm`` and a float64 sum differ by as much). The DP noise is
drawn with ``jax.random``, which torch cannot reproduce, so the port's
noise function is fed the JAX draws. The samplers cannot reproduce
``jax.random.choice`` either: they are held to their contract, and the
end-to-end run replays the JAX sampler's cohorts.

End to end, FedAvg with each transform (and the hp-driven chain, a sampled
cohort, an empty one, and an explicit server optimizer) runs two rounds against the live JAX engine at the
tolerances of ``test_torch_strategies.py``, wire bytes equal, except that
top-k and int8 decisions at their boundaries may fall the other way in a
bounded share of the elements (``FLIP_SHARE``, with the gaps measured).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import HyperParams as JHyperParams
from repro.core import aggregation as jaggregation
from repro.core import compression as jcompression
from repro.core import privacy as jprivacy
from repro.core import run_federated as jax_run_federated
from repro.core.comm import CommLog as JCommLog
from repro.strategies import sampling as jsampling
from repro.strategies import server_opt as jserver_opt
from repro.strategies import transforms as jtransforms
from repro.utils import tree_sq_norm as jax_tree_sq_norm
from repro.utils import tree_weighted_sum as jax_tree_weighted_sum
from repro_torch import interop
from repro_torch.core import HyperParams, run_federated
from repro_torch.core import aggregation, compression, privacy
from repro_torch.strategies import (ClientSampler, ClipNoiseDP, FedAdamOpt, FedAvgMOpt,
                                    FixedSizeSampler, TransformCtx, UniformSampler, WireMessage,
                                    decode_wire, default_transforms, round_seed)
from repro_torch.strategies import server_opt, transforms
from repro_torch.utils import tree_sq_norm, tree_weighted_sum
from test_torch_strategies import _moment_err, assert_run_matches
# one_torch_thread: the autouse fixture, in effect here too
from test_torch_training import (ADAPTER_TOL, HP, ROUNDS, _data, _port_server, _server,
                                 assert_tree_close, one_torch_thread)

# adapter-shaped trees: smoke llava's (d_model 256, rank 4) and a full-width leaf
SHAPES = {"text": {"down": (256, 4), "up": (4, 256)}, "image": {"down": (256, 4),
                                                                 "up": (4, 256)}}
WIDE = {"text": {"down": (4096, 64)}}
CLIP_TOL = 4 * 2.0 ** -24   # a few f32 ulps of the clipped delta, relative to its ∞-norm


def draw(seed, shapes=SHAPES, scale=0.05):
    rng = np.random.default_rng(seed)
    return {m: {n: (rng.standard_normal(sh) * scale).astype(np.float32)
                for n, sh in d.items()} for m, d in shapes.items()}


def jx(tree):
    return jax.tree.map(jnp.asarray, tree)


def th(tree):
    return interop.adapters_from_numpy(tree, "cpu")


def np_tree(tree):
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    return tree.numpy() if torch.is_tensor(tree) else np.asarray(tree)


def assert_tree_equal(got, want, what=""):
    got, want = np_tree(got), np_tree(want)
    assert sorted(got) == sorted(want), what
    for k in want:
        if isinstance(want[k], dict):
            assert_tree_equal(got[k], want[k], f"{what}.{k}")
        else:
            assert got[k].dtype == want[k].dtype, (what, k, got[k].dtype, want[k].dtype)
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what}.{k}")


def both(transform_name, ctx, theta, ref, state=None, **kw):
    """(JAX (msg, state), port (msg, state)) of one encode on the same inputs."""
    jt = getattr(jtransforms, transform_name)(**kw)
    pt = getattr(transforms, transform_name)(**kw)
    jmsg, jstate = jt.encode(jtransforms.TransformCtx(*ctx), jx(theta), jx(ref),
                             None if state is None else jx(state))
    pmsg, pstate = pt.encode(TransformCtx(*ctx), th(theta), th(ref),
                             None if state is None else th(state))
    return (jt, jmsg, jstate), (pt, pmsg, pstate)


# ---------------------------------------------------------------------------
# int8 + error feedback
# ---------------------------------------------------------------------------

def _int8_inputs(seed):
    theta, ref = draw(seed), draw(seed + 100)
    # edges: an all-zero delta (scale 1), exact half steps (round half to even), signs
    theta["image"]["up"] = ref["image"]["up"].copy()
    d = theta["text"]["up"] - ref["text"]["up"]
    step = np.float32(np.abs(d).max() / np.float32(127.0))
    theta["text"]["up"][0, :6] = ref["text"]["up"][0, :6] + step * np.float32(
        [0.5, 1.5, 2.5, -0.5, -1.5, -2.5])
    return theta, ref


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_ef_matches_reference_bit_for_bit(seed):
    theta, ref = _int8_inputs(seed)
    state = None
    for r in range(3):  # the residual carried round to round
        (jt, jmsg, jst), (pt, pmsg, pst) = both("Int8EFQuant", (seed, r), theta, ref, state)
        assert (pmsg.codec, pmsg.version, pmsg.nbytes) == (jmsg.codec, jmsg.version,
                                                           jmsg.nbytes)
        assert pmsg.nbytes == sum(a.size for m in theta.values() for a in m.values()) + 4 * 4
        assert_tree_equal(pmsg.payload["q"], jmsg.payload["q"], "payload")
        assert_tree_equal(pmsg.payload["scales"], jmsg.payload["scales"], "scales")
        assert_tree_equal(pst, jst, "residual")
        assert_tree_equal(decode_wire(pmsg, th(ref)), jtransforms.decode_wire(jmsg, jx(ref)),
                          "decoded")
        got, gst, wire = pt.apply(TransformCtx(seed, r), th(theta), th(ref),
                                  None if state is None else th(state))
        want, wst, jwire = jt.apply(jtransforms.TransformCtx(seed, r), jx(theta), jx(ref),
                                    None if state is None else jx(state))
        assert wire == jwire == jmsg.nbytes
        assert_tree_equal(got, want, "apply")
        state = np_tree(jst)
        theta = draw(seed + 10 * (r + 1))


def test_compression_functions_match_reference():
    theta, ref = _int8_inputs(3)
    err = draw(4, scale=1e-3)
    jq, jerr, jrec = jcompression.compress_update(jx(theta), jx(ref), jx(err))
    q, perr = compression.compress_update(th(theta), th(ref), th(err))
    assert q.wire_bytes == jq.wire_bytes
    assert_tree_equal(q.payload, jq.payload, "payload")
    assert_tree_equal(q.scales, jq.scales, "scales")
    assert_tree_equal(perr, jerr, "error")
    assert_tree_equal(compression.dequantize_delta(q), jrec, "recon")
    assert_tree_equal(compression.init_error_feedback(th(ref)),
                      jcompression.init_error_feedback(jx(ref)))


# ---------------------------------------------------------------------------
# top-k sparsification + error feedback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frac", [0.1, 0.013, 1e-9, 1.0])
@pytest.mark.parametrize("shapes", [SHAPES, WIDE], ids=["smoke", "wide"])
def test_topk_matches_reference_bit_for_bit(frac, shapes):
    theta, ref = draw(5, shapes), draw(6, shapes)
    state = None
    for r in range(2):
        (jt, jmsg, jst), (pt, pmsg, pst) = both("TopKSparsify", (1, r), theta, ref, state,
                                                frac=frac)
        assert (pmsg.codec, pmsg.version, pmsg.nbytes) == (jmsg.codec, jmsg.version,
                                                           jmsg.nbytes)
        for m in theta:
            for n, a in theta[m].items():
                k = max(1, int(round(frac * a.size)))
                pi, pv = pmsg.payload[m][n]["idx"].numpy(), pmsg.payload[m][n]["vals"].numpy()
                ji, jv = np.asarray(jmsg.payload[m][n]["idx"]), np.asarray(
                    jmsg.payload[m][n]["vals"])
                assert pi.dtype == ji.dtype == np.int32 and pi.shape == ji.shape == (k,)
                assert len(set(pi.tolist())) == k  # exactly k kept
                po, jo = np.argsort(pi), np.argsort(ji)
                np.testing.assert_array_equal(pi[po], ji[jo])   # the same set
                np.testing.assert_array_equal(pv[po], jv[jo])   # the same values
        assert_tree_equal(pst, jst, "residual")
        assert_tree_equal(decode_wire(pmsg, th(ref)), jtransforms.decode_wire(jmsg, jx(ref)),
                          "decoded")
        state = np_tree(jst)
        theta = draw(7 + r, shapes)


def test_topk_keeps_exactly_k_under_ties():
    theta = {"text": {"down": np.zeros((64, 4), np.float32)}}
    theta["text"]["down"][:, 0] = 1.0   # 64 equal magnitudes, k = 26
    ref = {"text": {"down": np.zeros((64, 4), np.float32)}}
    (_, jmsg, _), (_, pmsg, pst) = both("TopKSparsify", (0, 0), theta, ref, frac=0.1)
    k = 26
    idx = pmsg.payload["text"]["down"]["idx"].numpy()
    assert len(set(idx.tolist())) == k and pmsg.nbytes == jmsg.nbytes == k * 8
    assert set(idx.tolist()) == set(np.asarray(jmsg.payload["text"]["down"]["idx"]).tolist())
    assert np.all(theta["text"]["down"].reshape(-1)[idx] == 1.0)
    assert float(pst["text"]["down"].sum()) == 64 - k


# ---------------------------------------------------------------------------
# DP: clip and noise
# ---------------------------------------------------------------------------

def test_dp_clip_inactive_is_bit_for_bit():
    theta, ref = draw(8, scale=1e-3), draw(9)
    (jt, jmsg, _), (pt, pmsg, _) = both("ClipNoiseDP", (2, 1), theta, ref, clip_norm=10.0)
    assert (pmsg.codec, pmsg.nbytes) == (jmsg.codec, jmsg.nbytes)
    assert_tree_equal(pmsg.payload, jmsg.payload, "dp theta")
    got, _, wire = pt.apply(TransformCtx(2, 1), th(theta), th(ref), None)
    assert wire is None  # wire size unchanged


@pytest.mark.parametrize("seed", [10, 11, 12])
def test_dp_clip_active_matches_reference(seed):
    theta, ref = draw(seed), draw(seed + 50)
    delta = {m: {n: theta[m][n] - ref[m][n] for n in theta[m]} for m in theta}
    norm = float(np.sqrt(sum(np.sum(a.astype(np.float64) ** 2) for m in delta.values()
                             for a in m.values())))
    want, jinfo = jprivacy.privatize_update(None, jx(theta), jx(ref), clip_norm=0.2 * norm,
                                            noise_mult=0.0)
    got = privacy.privatize_update(None, th(theta), th(ref), clip_norm=0.2 * norm,
                                   noise_mult=0.0)
    assert abs(float(torch.sqrt(tree_sq_norm(th(delta)))) - float(jinfo["pre_clip_norm"])) \
        <= CLIP_TOL * norm
    for m in delta:
        for n in delta[m]:
            gd = got[m][n].numpy() - ref[m][n]
            wd = np.asarray(want[m][n]) - ref[m][n]
            assert np.max(np.abs(gd - wd)) <= CLIP_TOL * np.max(np.abs(wd)) + \
                2 * np.spacing(np.max(np.abs(ref[m][n]))), (m, n)
    # the clipped delta's norm is the clip
    jd, _ = jprivacy.clip_by_global_norm(jx(delta), 0.2 * norm)
    pd = privacy.clip_by_global_norm(th(delta), 0.2 * norm)
    assert float(torch.sqrt(tree_sq_norm(pd))) == pytest.approx(0.2 * norm, rel=1e-6)
    assert float(np.sqrt(jax_tree_sq_norm(jd))) == pytest.approx(0.2 * norm, rel=1e-6)


def test_dp_noise_from_the_reference_draw_is_bit_for_bit():
    """The JAX package's noise on one tree, its normal draws fed to the port."""
    delta = draw(13)
    key = jax.random.fold_in(jax.random.PRNGKey(1234 + 3), 1)
    want = jprivacy.add_gaussian_noise(key, jx(delta), 0.7)
    leaves, treedef = jax.tree_util.tree_flatten(jx(delta))
    keys = jax.random.split(key, len(leaves))
    z = jax.tree_util.tree_unflatten(treedef, [np.asarray(jax.random.normal(k, x.shape,
                                                                            jnp.float32))
                                               for x, k in zip(leaves, keys)])
    got = privacy.add_gaussian_noise(th(delta), th(z), 0.7)
    assert_tree_equal(got, want, "noised")


def test_dp_noise_stream_is_per_client_and_round():
    theta, ref = draw(14), draw(15)
    t = ClipNoiseDP(clip_norm=1e3, noise_mult=0.01)
    a = t.apply(TransformCtx(1, 0), th(theta), th(ref), None)[0]
    b = t.apply(TransformCtx(1, 0), th(theta), th(ref), None)[0]
    c = t.apply(TransformCtx(2, 0), th(theta), th(ref), None)[0]
    d = t.apply(TransformCtx(1, 1), th(theta), th(ref), None)[0]
    assert_tree_equal(a, b, "same (cid, round)")
    noise = a["text"]["down"] - th(theta)["text"]["down"]
    assert 0.5 * 10.0 < float(noise.std()) < 2 * 10.0  # σ = noise_mult · clip_norm
    for other in (c, d):
        assert not torch.equal(a["text"]["down"], other["text"]["down"])


def test_wire_protocol_refuses_unknown_stamps():
    ref = th(draw(16))
    with pytest.raises(ValueError, match="format version"):
        decode_wire(WireMessage("identity", 99, ref, 0), ref)
    with pytest.raises(ValueError, match="unknown wire codec"):
        decode_wire(WireMessage("zstd", 1, ref, 0), ref)
    assert transforms.WIRE_FORMAT_VERSION == jtransforms.WIRE_FORMAT_VERSION


@pytest.mark.parametrize("hp", [dict(), dict(dp_clip=0.5, dp_noise=1.1), dict(
    compress_uploads=True), dict(dp_clip=0.5, compress_uploads=True)],
    ids=["none", "dp", "int8", "dp+int8"])
def test_default_transforms_match_reference(hp):
    mine, ref = default_transforms(HyperParams(**hp)), jtransforms.default_transforms(
        JHyperParams(**hp))
    assert [type(t).__name__ for t in mine] == [type(t).__name__ for t in ref]
    assert [dataclasses.asdict(t) for t in mine] == [dataclasses.asdict(t) for t in ref]
    assert [t.wire_transparent for t in mine] == [t.wire_transparent for t in ref]


# ---------------------------------------------------------------------------
# server optimizers, FedAvg mean, tree helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opt", ["FedAvgMOpt", "FedAdamOpt"])
def test_server_opts_match_reference(opt):
    jo, po = getattr(jserver_opt, opt)(), {"FedAvgMOpt": FedAvgMOpt,
                                            "FedAdamOpt": FedAdamOpt}[opt]()
    assert dataclasses.asdict(jo) == dataclasses.asdict(po)
    g = draw(17)
    js, ps = jo.init(jx(g)), po.init(th(g))
    jg, pg = jx(g), th(g)
    for r in range(3):
        merged = draw(18 + r)
        jg, js = jo.apply(js, jg, jx(merged))
        pg, ps = po.apply(ps, pg, th(merged))
        if opt == "FedAvgMOpt":
            assert_tree_equal(pg, jg, f"params round {r}")
            assert_tree_equal(ps, js, f"state round {r}")
        else:  # XLA's CPU sqrt is not always correctly rounded: an ulp off on some draws
            for got, want in ((pg, jg), (ps["m"], js["m"]), (ps["v"], js["v"])):
                assert_tree_close(got, want, 1e-6, f"round {r}")


@pytest.mark.parametrize("sizes", [[16, 16], [5, 11, 3], None, [0, 0]])
def test_fedavg_matches_reference(sizes):
    k = 2 if sizes is None else len(sizes)
    thetas = [draw(20 + i) for i in range(k)]
    want = jaggregation.fedavg([jx(t) for t in thetas], sizes)
    got = aggregation.fedavg([th(t) for t in thetas], sizes)
    for m in want:
        for n in want[m]:
            w = np.asarray(want[m][n])
            assert np.max(np.abs(got[m][n].numpy() - w)) <= 1e-6 * np.max(np.abs(w))


def test_tree_helpers_match_reference():
    trees = [draw(30 + i) for i in range(3)]
    sq = float(jax_tree_sq_norm(jx(trees[0])))
    assert float(tree_sq_norm(th(trees[0]))) == pytest.approx(sq, rel=1e-6)
    want = jax_tree_weighted_sum([jx(t) for t in trees], [3.0, 1.0, 7.0])
    got = tree_weighted_sum([th(t) for t in trees], [3.0, 1.0, 7.0])
    for m in want:
        for n in want[m]:
            np.testing.assert_allclose(got[m][n].numpy(), np.asarray(want[m][n]), rtol=1e-6,
                                       atol=1e-7)


# ---------------------------------------------------------------------------
# samplers: the contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 3, 7, 10])
@pytest.mark.parametrize("frac", [0.0, 0.1, 0.25, 0.5, 0.99, 1.0])
def test_uniform_sampler_contract(k, frac):
    cids = [3 * i + 1 for i in range(k)]  # not 0..K-1, to catch index/id mix-ups
    ref = jsampling.UniformSampler(frac=frac, seed=5)
    for r in range(4):
        cohort = UniformSampler(frac=frac, seed=5).select(r, cids)
        assert len(cohort) == len(ref.select(r, cids)) == min(k, max(1, int(round(frac * k))))
        assert cohort == sorted(cohort) and len(set(cohort)) == len(cohort)
        assert set(cohort) <= set(cids)
        assert UniformSampler(frac=frac, seed=5).select(r, cids) == cohort  # a pure function


@pytest.mark.parametrize("n", [0, 1, 3, 10, 12])
def test_fixed_size_sampler_contract(n):
    cids = list(range(10))
    for r in range(4):
        cohort = FixedSizeSampler(n=n, seed=2).select(r, cids)
        assert len(cohort) == len(jsampling.FixedSizeSampler(n=n, seed=2).select(r, cids)) \
            == min(max(1, n), 10)
        assert cohort == sorted(cohort) and set(cohort) <= set(cids)
        assert FixedSizeSampler(n=n, seed=2).select(r, cids) == cohort
    assert ClientSampler().select(0, cids) == cids


def test_sampler_draws_depend_on_seed_and_round_only():
    cids = list(range(20))
    s = UniformSampler(frac=0.3, seed=9)
    by_round = [s.select(r, cids) for r in range(6)]
    assert [s.select(r, cids) for r in reversed(range(6))] == by_round[::-1]  # no carried state
    assert len({tuple(c) for c in by_round}) > 1
    assert UniformSampler(frac=0.3, seed=10).select(0, cids) != by_round[0] or \
        UniformSampler(frac=0.3, seed=10).select(1, cids) != by_round[1]
    assert round_seed(9, 0) == round_seed(9, 0) != round_seed(9, 1) != round_seed(10, 0)


# ---------------------------------------------------------------------------
# end to end: FedAvg with the transforms and a sampled cohort
# ---------------------------------------------------------------------------

class _Replay:
    """A sampler that returns given cohorts round by round."""

    def __init__(self, cohorts):
        self.cohorts = cohorts

    def select(self, round_idx, cids):
        return list(self.cohorts[round_idx])


def _chain(spec, pkg):
    """The transform chain named ``spec`` from ``pkg`` (the JAX transforms
    module or the port's); None for the hp-driven default."""
    return {"topk": lambda: (pkg.TopKSparsify(frac=0.1),),
            "int8": lambda: (pkg.Int8EFQuant(),),
            "dp": lambda: (pkg.ClipNoiseDP(clip_norm=0.01, noise_mult=0.0),),
            "dp+topk": lambda: (pkg.ClipNoiseDP(clip_norm=0.01), pkg.TopKSparsify(frac=0.25)),
            }.get(spec, lambda: None)()


E2E_HP = {"hp": dict(dp_clip=0.01, compress_uploads=True)}
JAX_SAMPLER = jsampling.UniformSampler(frac=0.5, seed=3)
# the cohorts of each run with a sampler: the JAX UniformSampler's, and an
# empty round 1 (mean_loss None, nothing merged or logged)
COHORTS = {"sampler": [JAX_SAMPLER.select(r, [0, 1]) for r in range(ROUNDS)],
           "empty": [[0, 1], []]}


def _server_opt(spec, pkg):
    """An explicit FedAdam server step on FedAvg (the strategy has none)."""
    return pkg.FedAdamOpt(lr=0.05) if spec == "server-opt" else None


@functools.lru_cache(maxsize=None)
def _jax_e2e(spec):
    jcfg, (jtrain, jeval, _), _, _ = _data(False)
    jsrv = dataclasses.replace(_server()[0], comm=JCommLog())
    return jax_run_federated(jax.random.PRNGKey(0), jcfg, jtrain, jeval, strategy="fedavg",
                             rounds=ROUNDS, hp=JHyperParams(**HP, **E2E_HP.get(spec, {})),
                             server=jsrv, transforms=_chain(spec, jtransforms),
                             sampler=_Replay(COHORTS[spec]) if spec in COHORTS else None,
                             server_opt=_server_opt(spec, jserver_opt))


# The share of a leaf's elements that may differ from the reference by more
# than ADAPTER_TOL after two rounds: the whole decisions of top-k and int8.
# Each local θ is 1e-5 of the reference's (the module docstring of
# test_torch_training.py), and AdamW's first steps move every element by
# about lr, so the k-th largest |δ| has near neighbours within that 1e-5 and
# the kept set differs at its edge. A swapped element costs its whole δ
# (0.53 of an up leaf's ∞-norm), and round 1 then starts from other global
# adapters. Measured on the CPU, the port against the JAX package: top-k 46
# of 1024 elements (image.up), int8 1 (text.down, one quantization step),
# DP + top-k 3; the JAX package's own two paths (Pallas LoRA against jnp)
# flip as many top-k elements in the same run. Every other element within
# ADAPTER_TOL, round losses within 1e-5, wire bytes equal.
FLIP_SHARE = {"topk": 0.08, "int8": 0.005, "dp+topk": 0.005}


def assert_adapters_within_flips(got, want, share, what):
    got = interop.adapters_to_numpy(got)
    for m in want:
        for n in want[m]:
            w = np.asarray(want[m][n])
            off = np.abs(got[m][n] - w) > ADAPTER_TOL * np.max(np.abs(w))
            assert off.sum() <= share * w.size, (what, m, n, int(off.sum()))


@pytest.mark.parametrize("spec", ["topk", "int8", "dp", "dp+topk", "hp", "sampler", "empty",
                                  "server-opt"])
@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernels"])
def test_fedavg_with_transforms_matches_reference(use_pallas, spec):
    want = _jax_e2e(spec)
    _, _, cfg, (train_b, eval_b, _) = _data(use_pallas)
    got = run_federated(0, cfg, train_b, eval_b, strategy="fedavg", rounds=ROUNDS,
                        hp=HyperParams(**HP, **E2E_HP.get(spec, {})), use_pallas=use_pallas,
                        server=_port_server(cfg), transforms=_chain(spec, transforms),
                        sampler=_Replay(COHORTS[spec]) if spec in COHORTS else None,
                        server_opt=_server_opt(spec, server_opt))
    if spec in FLIP_SHARE:
        assert_adapters_within_flips(got.server.global_adapters, want.server.global_adapters,
                                     FLIP_SHARE[spec], spec)
    assert_run_matches(got, want, spec, adapters=spec not in FLIP_SHARE)
    c = got.comm_totals
    leaf = c["param_down"] // sum(m["participants"] for m in got.round_metrics)
    n_up = sum(m["participants"] for m in got.round_metrics)
    n_el = leaf // 4
    wire = {"topk": n_up * sum(max(1, round(0.1 * n_el / 4)) for _ in range(4)) * 8,
            "dp+topk": n_up * sum(max(1, round(0.25 * n_el / 4)) for _ in range(4)) * 8,
            "int8": n_up * (n_el + 4 * 4), "hp": n_up * (n_el + 4 * 4)}
    assert c["param_up"] == n_up * leaf
    assert c["param_up_wire"] == wire.get(spec, n_up * leaf)
    if spec in COHORTS:
        assert [m["participants"] for m in got.round_metrics] == \
            [len(c) for c in COHORTS[spec]]
    if spec == "empty":
        assert got.round_metrics[1]["mean_loss"] is None and got.server.round_idx == 1
    if spec == "server-opt":
        scale = max(float(np.max(np.abs(a))) for m in want.server.global_adapters.values()
                    for a in m.values())
        for k, s in (("m", scale), ("v", scale ** 2)):
            assert _moment_err(got.server_opt_state[k], want.server_opt_state[k], s) <= \
                ADAPTER_TOL, k
