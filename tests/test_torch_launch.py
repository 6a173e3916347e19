"""The port's launch layer (``repro_torch.launch.{steps, sharding_rules, mesh,
roofline, dryrun}``, ``chunked_sdpa``, ``chunked_lm_loss``, the Tab. 1
counts, ``resolve_spec``) against the JAX package's.

Smoke configs in f32 on the CPU. The JAX package draws the backbones and the
adapters' ``down``, exported through ``repro_torch.interop``; ``up``, the
batches and the decode states come from numpy seeds. Step outputs are held
at 1e-5 of ‖ref‖∞, chunked attention and loss at 1e-6, counts and per-card
footprints exactly. The abstract inputs (meta tensors) are held against
``jax.eval_shape``'s leaf by leaf, shape and dtype, at full width.
"""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS as J_ASSIGNED
from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import PAPER_ARCHS as J_PAPER
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import Batch as JBatch
from repro.core import adapters as jnano
from repro.core import comm as jcomm
from repro.launch import roofline as jroofline
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.optim import adamw_init as jadamw_init
from repro.sharding import resolve_spec as jresolve_spec
from repro_torch import interop
from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, PAPER_ARCHS, InputShape
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import comm
from repro_torch.core.types import Batch
from repro_torch.launch import dryrun, roofline, steps
from repro_torch.launch.mesh import LAYOUTS
from repro_torch.models import attention as attn
from repro_torch.models import encdec, rglru, ssm, transformer
from repro_torch.models import layers
from repro_torch.models import model as model_lib
from repro_torch.models.rotary import make_angles
from repro_torch.models.vision_stub import num_patches
from repro_torch.optim import adamw_init
from repro_torch.sharding import resolve_spec
from repro_torch.utils import tree_flatten_with_path, tree_map, tree_size

from test_torch_training import one_torch_thread, rel_err  # noqa: F401

STEP_ARCHS = ["h2o-danube-1.8b", "mamba2-130m", "grok-1-314b", "recurrentgemma-9b",
              "whisper-base", "qwen2-vl-72b"]
ALL_ARCHS = ASSIGNED_ARCHS + PAPER_ARCHS
B, S = 2, 32
TOL = 1e-5
# the updated adapters: max(TOL, this times the port's own f32 step's
# distance from its f64 step), as tests/test_torch_mrope.py holds rounds
ROUNDING_MARGIN = 2.0
FAR_POS = 524_287


def test_registries_match_reference():
    assert ASSIGNED_ARCHS == J_ASSIGNED and PAPER_ARCHS == J_PAPER
    assert {k: dataclasses.astuple(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in J_SHAPES.items()}
    for arch in ALL_ARCHS:
        assert get_config(arch).subquadratic == jax_get_config(arch).subquadratic, arch


# ---------------------------------------------------------------------------
# helpers: trees of both packages by path
# ---------------------------------------------------------------------------

def _jax_path(path) -> str:
    names = []
    for p in path:
        for attr in ("key", "name", "idx"):
            if hasattr(p, attr):
                names.append(str(getattr(p, attr)))
                break
    return "/".join(names)


def jax_flat(tree) -> dict:
    return {_jax_path(p): leaf for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_flat(tree) -> dict:
    return dict(tree_flatten_with_path(tree))


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def assert_specs_equal(port_tree, jax_tree, what, stacked=False):
    jf = {p: (tuple(l.shape), jnp.dtype(l.dtype).name) for p, l in jax_flat(jax_tree).items()}
    if stacked:
        pf = {}
        for path, leaf in port_flat(port_tree).items():
            parts = path.split("/")
            if any(p.isdigit() for p in parts):
                key = "/".join(p for p in parts if not p.isdigit())
                n, shape, dt = pf.get(key, (0, tuple(leaf.shape), _dtype_name(leaf.dtype)))
                assert shape == tuple(leaf.shape), (what, path)
                pf[key] = (n + 1, shape, dt)
            else:
                pf[path] = (None, tuple(leaf.shape), _dtype_name(leaf.dtype))
        got = {k: ((shape if n is None else (n,) + shape), dt) for k, (n, shape, dt) in pf.items()}
    else:
        got = {p: (tuple(l.shape), _dtype_name(l.dtype)) for p, l in port_flat(port_tree).items()}
    assert got == jf, what


# ---------------------------------------------------------------------------
# the three step functions against JAX's
# ---------------------------------------------------------------------------

def _batch_np(cfg, seed, b=B, s=S):
    rng = np.random.default_rng(seed)
    s_text = steps.text_seq_len(cfg, s)
    patches = None
    if cfg.frontend_dim:
        patches = rng.standard_normal((b, num_patches(cfg), cfg.frontend_dim)).astype(np.float32)
    return dict(tokens=rng.integers(0, cfg.vocab_size, (b, s_text)).astype(np.int32),
                labels=rng.integers(0, cfg.vocab_size, (b, s_text)).astype(np.int32),
                mask=(rng.random((b, s_text)) < 0.7).astype(np.float32), patches=patches)


def _batches(arrays):
    jb = JBatch(tokens=jnp.asarray(arrays["tokens"]), labels=jnp.asarray(arrays["labels"]),
                mask=jnp.asarray(arrays["mask"]),
                patches=None if arrays["patches"] is None else jnp.asarray(arrays["patches"]))
    pb = Batch(*(None if a is None else torch.from_numpy(a) for a in
                 (arrays["tokens"], arrays["labels"], arrays["mask"], arrays["patches"])))
    return jb, pb


@functools.lru_cache(maxsize=None)
def _setup(arch, use_pallas):
    jcfg = jax_smoke_config(arch).with_(use_pallas=use_pallas)
    cfg = get_smoke_config(arch).with_(use_pallas=use_pallas)
    backbone = jax.tree.map(np.asarray, jmodel.init_backbone(jax.random.PRNGKey(21), jcfg))
    rng = np.random.default_rng(22)
    adapters = {m: {"down": np.asarray(a["down"]),
                    "up": (rng.standard_normal(a["up"].shape) * 0.05).astype(np.float32)}
                for m, a in jnano.init_nanoedge(jax.random.PRNGKey(22), jcfg).items()}
    return jcfg, cfg, backbone, adapters


def _port(cfg, backbone, adapters):
    return (interop.backbone_from_numpy(cfg, backbone, "cpu"),
            interop.adapters_from_numpy(adapters, "cpu"))


def _jax_pallas(arch, kind, use_pallas):
    """Whether the reference runs its Pallas kernels: not in mamba2's train
    step, whose SSD kernel the JAX package cannot differentiate (its
    use_pallas=False step is the reference there)."""
    return use_pallas and not (arch == "mamba2-130m" and kind == "train")


def assert_flat_close(got: dict, want: dict, what, tol=TOL):
    assert sorted(got) == sorted(want), what
    for path in want:
        e = rel_err(got[path], np.asarray(want[path], np.float32))
        assert e <= tol, f"{what} {path}: {e:.3e} > {tol:.3e}"


def _train_f64(cfg, jcfg, bb, adp, pb, backbone, adapters, jb):
    """Both packages' train step on the same weights and batch in float64 ->
    ({path: the port's updated adapters}, {path: JAX's}) as f32 numpy."""
    c64 = cfg.with_(dtype="float64", adapter=dataclasses.replace(cfg.adapter, dtype="float64"))
    up = functools.partial(tree_map, lambda t: t.double())
    got = steps.make_train_step(c64)(up(bb), up(adp), adamw_init(up(adp)),
                                     pb._replace(patches=None if pb.patches is None
                                                 else pb.patches.double()))
    with jax.enable_x64():
        j64 = jcfg.with_(dtype="float64", adapter=dataclasses.replace(jcfg.adapter,
                                                                      dtype="float64"))
        up = functools.partial(jax.tree.map, lambda a: np.asarray(a, np.float64)
                               if np.asarray(a).dtype == np.float32 else a)
        ad = up(adapters)
        want = jax.jit(jsteps.make_train_step(j64))(up(backbone), ad, jadamw_init(ad),
                                                    jb._replace(patches=up(jb.patches)))
        want = {k: np.asarray(v, np.float32) for k, v in jax_flat(want[0]).items()}
    return {k: v.float().numpy() for k, v in port_flat(got[0]).items()}, want


STEP_CASES = ([(a, k, False) for a in STEP_ARCHS for k in ("train", "prefill", "decode")]
              + [(a, k, True) for a in ("h2o-danube-1.8b", "mamba2-130m")
                 for k in ("train", "prefill", "decode")])


@pytest.mark.parametrize("arch,kind,use_pallas", STEP_CASES,
                         ids=[f"{a}-{k}-{'pallas' if p else 'plain'}" for a, k, p in STEP_CASES])
def test_step_matches_reference(arch, kind, use_pallas):
    jcfg, cfg, backbone, adapters = _setup(arch, use_pallas)
    jcfg = jcfg.with_(use_pallas=_jax_pallas(arch, kind, use_pallas))
    jb, pb = _batches(_batch_np(cfg, seed=23))
    bb, adp = _port(cfg, backbone, adapters)
    if kind == "train":
        want = jax.jit(jsteps.make_train_step(jcfg))(backbone, adapters, jadamw_init(adapters), jb)
        got = steps.make_train_step(cfg)(bb, adp, adamw_init(adp), pb)
        assert rel_err(got[2], np.asarray(want[2])) <= TOL, "loss"
        assert_flat_close(port_flat(got[1]), jax_flat(want[1]), "AdamW state")
        assert_flat_close(port_flat(got[3]), jax_flat(want[3]), "fisher_sq")
        # AdamW's first step moves each element by about lr·g/|g|: where |g|
        # nears its eps, each package's f32 rounding of g moves the update
        # itself. Where an element misses TOL, the bound is ROUNDING_MARGIN
        # times the larger of the two packages' own f32-to-f64 distances.
        new, jnew = port_flat(got[0]), jax_flat(want[0])
        if max(rel_err(new[k], np.asarray(jnew[k])) for k in jnew) > TOL:
            p64, j64 = _train_f64(cfg, jcfg, bb, adp, pb, backbone, adapters, jb)
            witness = max(max(rel_err(new[k], p64[k]) for k in new),
                          max(rel_err(torch.from_numpy(np.asarray(jnew[k])), j64[k])
                              for k in jnew))
            assert_flat_close(new, jnew, "adapters'", max(TOL, ROUNDING_MARGIN * witness))
        return
    # decode starts from the prefill's state, one slot past the prompt
    cap = S + 4
    jstate, jlast = jax.jit(jsteps.make_prefill_step(jcfg, cap))(backbone, adapters, jb)
    state, last = steps.make_prefill_step(cfg, cap)(bb, adp, pb)
    if kind == "prefill":
        assert rel_err(last, np.asarray(jlast)) <= TOL, "last logits"
        assert_flat_close(port_flat(state), jax_flat(jstate), "state")
        return
    tok = np.random.default_rng(24).integers(0, cfg.vocab_size, (B,)).astype(np.int32)
    jlg, jstate = jax.jit(jsteps.make_decode_step(jcfg))(backbone, adapters, jstate,
                                                         jnp.asarray(tok), jnp.int32(S))
    lg, state = steps.make_decode_step(cfg)(bb, adp, state, torch.from_numpy(tok),
                                            torch.tensor(S, dtype=torch.int32))
    assert rel_err(lg, np.asarray(jlg)) <= TOL, "decode logits"
    assert_flat_close(port_flat(state), jax_flat(jstate), "decode state")


# ---------------------------------------------------------------------------
# abstract inputs at full width: meta tensors against jax.eval_shape
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_parameter_specs_match_eval_shape(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    bb = steps.backbone_specs(cfg)
    assert all(t.device.type == "meta" for t in port_flat(bb).values())
    assert_specs_equal(bb, jsteps.backbone_specs(jcfg), f"{arch} backbone", stacked=True)
    assert_specs_equal(steps.adapter_specs(cfg), jsteps.adapter_specs(jcfg), f"{arch} adapters")
    assert_specs_equal(steps.opt_state_specs(cfg), jsteps.opt_state_specs(jcfg), f"{arch} opt")


@pytest.mark.parametrize("arch", ALL_ARCHS)
@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
def test_input_specs_match_eval_shape(arch, shape):
    """Every input, the decode states at decode_32k and long_500k included."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert_specs_equal(steps.input_specs(cfg, INPUT_SHAPES[shape]),
                       jsteps.input_specs(jcfg, J_SHAPES[shape]), f"{arch} x {shape}")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_workload_policy_matches_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert steps._depth_points(cfg) == jsteps._depth_points(jcfg)
    common = [f.name for f in dataclasses.fields(cfg)]
    for name, shape in INPUT_SHAPES.items():
        jshape = J_SHAPES[name]
        assert steps.text_seq_len(cfg, shape.seq_len) == jsteps.text_seq_len(jcfg, shape.seq_len)
        assert steps.shape_supported(cfg, shape) == jsteps.shape_supported(jcfg, jshape)
        for mode in ("full", "roofline"):
            for ov in (None, {"loss_chunk": 512}, {"attn_chunk": 256}):
                got = steps.exec_config(cfg, shape, mode, ov)
                want = jsteps.exec_config(jcfg, jshape, mode, ov)
                for f in common:
                    if f not in ("adapter", "ssm", "moe", "rglru"):
                        assert getattr(got, f) == getattr(want, f), (name, mode, ov, f)


def test_unported_switch_override_raises():
    cfg = get_smoke_config("h2o-danube-1.8b")
    assert steps.UNPORTED_SWITCHES == ("scan_layers", "seq_parallel", "ctx_parallel_attn")
    for switch in steps.UNPORTED_SWITCHES:
        with pytest.raises(ValueError, match=switch):
            steps.exec_config(cfg, INPUT_SHAPES["train_4k"], "full", {switch: False})


# ---------------------------------------------------------------------------
# chunked attention and chunked loss
# ---------------------------------------------------------------------------

# (S, chunk, n_heads, n_kv, window, softcap): S off the chunk, GQA, window, softcap
CHUNK_CASES = [(37, 8, 4, 4, None, 0.0), (40, 16, 8, 2, None, 0.0), (45, 8, 4, 1, 12, 0.0),
               (33, 16, 6, 2, 20, 30.0), (24, 8, 4, 2, None, 5.0)]


@pytest.mark.parametrize("s,chunk,nh,nkv,window,cap", CHUNK_CASES)
def test_chunked_sdpa_matches_reference(s, chunk, nh, nkv, window, cap):
    rng = np.random.default_rng(s + chunk)
    hd = 16
    q = rng.standard_normal((2, s, nh, hd)).astype(np.float32)
    k, v = (rng.standard_normal((2, s, nkv, hd)).astype(np.float32) for _ in range(2))
    kw = dict(n_heads=nh, n_kv_heads=nkv, sliding_window=window, logit_softcap=cap)
    want = jattn.chunked_sdpa(jax_smoke_config("h2o-danube-1.8b").with_(**kw), jnp.asarray(q),
                              jnp.asarray(k), jnp.asarray(v), chunk=chunk)
    cfg = get_smoke_config("h2o-danube-1.8b").with_(**kw)
    got = attn.chunked_sdpa(cfg, *(torch.from_numpy(a) for a in (q, k, v)), chunk=chunk)
    assert rel_err(got, np.asarray(want)) <= 1e-6
    # and the plain sdpa with the causal (windowed) mask, row by row
    full = attn.sdpa(cfg, *(torch.from_numpy(a) for a in (q, k, v)),
                     attn.causal_mask(s, s, window=window))
    assert rel_err(got, full.numpy()) <= 1e-6


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "grok-1-314b"])
def test_full_attention_takes_chunked_sdpa(arch, monkeypatch):
    jcfg = jax_smoke_config(arch).with_(attn_chunk=8)
    cfg = get_smoke_config(arch).with_(attn_chunk=8)
    params = jax.tree.map(np.asarray, jattn.init_attention(jax.random.PRNGKey(3), jcfg))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 29, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(29), (2, 29))
    from repro.models.rotary import rope_angles as jrope
    from repro_torch.models.rotary import rope_angles
    want = jax.jit(lambda x, a: jattn.full_attention(jcfg, params, x, a))(
        jnp.asarray(x), jrope(jnp.asarray(pos), jcfg.resolved_head_dim, jcfg.rope_theta))
    calls = []
    monkeypatch.setattr(attn, "chunked_sdpa",
                        lambda *a, **k: calls.append(k["chunk"]) or CHUNKED(*a, **k))
    got = attn.full_attention(cfg, interop.adapters_from_numpy(params, "cpu"),
                              torch.from_numpy(x),
                              rope_angles(torch.from_numpy(pos.copy()), cfg.resolved_head_dim,
                                          cfg.rope_theta))
    assert calls == [8]
    assert rel_err(got, np.asarray(want)) <= 1e-6


CHUNKED = attn.chunked_sdpa


def _loss_inputs(seed, b=4, s=21, d=32, v=50):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, d)).astype(np.float32),
            (rng.standard_normal((v, d)) * 0.3).astype(np.float32),
            rng.integers(0, v, (b, s)).astype(np.int32),
            (rng.random((b, s)) < 0.6).astype(np.float32))


@pytest.mark.parametrize("chunk", [4, 7, 21, 32])
def test_chunked_lm_loss_matches_reference(chunk):
    h, table, labels, mask = _loss_inputs(chunk)
    jval, jgrad = jax.jit(jax.value_and_grad(
        lambda x: jlayers.chunked_lm_loss(x, jnp.asarray(table), jnp.asarray(labels),
                                          jnp.asarray(mask), chunk=chunk)))(jnp.asarray(h))
    x = torch.from_numpy(h).requires_grad_(True)
    val = layers.chunked_lm_loss(x, torch.from_numpy(table), torch.from_numpy(labels),
                                 torch.from_numpy(mask), chunk=chunk)
    (grad,) = torch.autograd.grad(val, x)
    assert rel_err(val.detach(), np.asarray(jval)) <= 1e-6
    assert rel_err(grad, np.asarray(jgrad)) <= 1e-6


@pytest.mark.parametrize("tied", [False, True])
def test_loss_fn_takes_chunked_loss(tied):
    """``loss_fn`` with ``loss_chunk`` on the tied and the untied table, value
    and d/dembeds against JAX's ``loss_fn``; with ``clients=K`` each client's
    own loss against JAX's on that client's rows."""
    arch = "h2o-danube-1.8b"
    jcfg = jax_smoke_config(arch).with_(loss_chunk=8, tie_embeddings=tied)
    cfg = get_smoke_config(arch).with_(loss_chunk=8, tie_embeddings=tied)
    params = jax.tree.map(np.asarray, jmodel.init_backbone(jax.random.PRNGKey(5), jcfg))
    bb = interop.backbone_from_numpy(cfg, params, "cpu")
    rng = np.random.default_rng(6)
    k, b, s = 2, 2, 27
    emb = (rng.standard_normal((k * b, s, cfg.d_model)) * 0.5).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (k * b, s)).astype(np.int32)
    mask = (rng.random((k * b, s)) < 0.6).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (k * b, s)).copy()

    def jloss(e, rows=slice(None)):
        return jmodel.loss_fn(jcfg, params, e, jnp.asarray(pos[rows]), jnp.asarray(labels[rows]),
                              jnp.asarray(mask[rows]))[0]

    jval, jgrad = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(emb))
    e = torch.from_numpy(emb).requires_grad_(True)
    args = (torch.from_numpy(pos), torch.from_numpy(labels), torch.from_numpy(mask))
    val = model_lib.loss_fn(cfg, bb, e, *args)[0]
    (grad,) = torch.autograd.grad(val, e)
    assert rel_err(val.detach(), np.asarray(jval)) <= 1e-6
    assert rel_err(grad, np.asarray(jgrad)) <= 1e-6
    per = model_lib.loss_fn(cfg, bb, torch.from_numpy(emb), *args, clients=k)[0]
    assert per.shape == (k,)
    for c in range(k):
        rows = slice(c * b, (c + 1) * b)
        assert rel_err(per[c], np.asarray(jloss(jnp.asarray(emb[rows]), rows))) <= 1e-6
    # the full-logits path on the same inputs agrees too
    plain = model_lib.loss_fn(cfg.with_(loss_chunk=None), bb, torch.from_numpy(emb), *args)[0]
    assert rel_err(plain, val.detach().numpy()) <= 1e-6


# ---------------------------------------------------------------------------
# Tab. 1 counts and the roofline's model FLOPs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_counts_match_reference(arch, capsys):
    for getter, jgetter in ((get_config, jax_get_config), (get_smoke_config, jax_smoke_config)):
        cfg, jcfg = getter(arch), jgetter(arch)
        assert comm.backbone_param_count(cfg) == jcomm.backbone_param_count(jcfg)
        assert comm.adapter_upload_params(cfg) == jcomm.adapter_upload_params(jcfg)
        assert comm.client_storage_params(cfg) == jcomm.client_storage_params(jcfg)
        for name, shape in INPUT_SHAPES.items():
            assert roofline.model_flops_estimate(cfg, shape) == \
                jroofline.model_flops_estimate(jcfg, J_SHAPES[name])
    # the drawn backbones beside the formula, at smoke size: the JAX formula
    # leaves out whisper's LayerNorm biases (2 a encoder layer, 3 a decoder
    # layer, the final norm's) and its encoder's final norm, 33 x 512 of its
    # 114,990,592 drawn parameters at full width (a reference-side finding)
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    drawn = tree_size(steps.backbone_specs(cfg))
    jdrawn = sum(int(np.prod(l.shape)) for l in jax.tree.leaves(jsteps.backbone_specs(jcfg)))
    formula = comm.backbone_param_count(cfg)
    assert drawn == jdrawn
    missed = ((2 * cfg.n_enc_layers + 3 * cfg.n_layers + 3) * cfg.d_model
              if cfg.family == "audio" else 0)
    assert drawn - formula == missed
    with capsys.disabled():
        print(f"\n[counts] {arch} smoke: drawn {drawn}, backbone_param_count {formula}")


# ---------------------------------------------------------------------------
# sharding: resolve_spec and the per-card footprint against JAX's
# ---------------------------------------------------------------------------

def _abstract_mesh(lay):
    from jax.sharding import AbstractMesh

    return AbstractMesh(tuple(lay.values()), tuple(lay))


def _norm_spec(p):
    return tuple(None if a is None else ((a,) if isinstance(a, str) else tuple(a)) for a in p)


@pytest.mark.parametrize("layout_name", list(LAYOUTS))
def test_resolve_spec_matches_reference(layout_name):
    lay = LAYOUTS[layout_name]
    mesh = _abstract_mesh(lay)
    specs = [("data", None), ("model", None), (None, "model"), (("data", "model"), None),
             (("pod", "data"), "model"), (None, ("data", "data", "model")), (None, None)]
    for shape in ((32, 48), (16, 20), (512, 8), (2, 4096), (1, 1)):
        for spec in specs:
            assert resolve_spec(lay, shape, spec) == _norm_spec(jresolve_spec(mesh, shape, spec))


@pytest.fixture(scope="module")
def jax_dryrun():
    """``repro.launch.dryrun``, imported after JAX has initialized (its first
    lines set XLA_FLAGS for 512 host devices, which then change nothing); the
    variable is restored for the processes later tests start."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jdryrun
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return jdryrun


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_footprint_matches_reference(arch, jax_dryrun):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for layout_name in ("1x1", "16x16", "2x16x16") + (("1x8",) if arch == "grok-1-314b" else ()):
        lay = LAYOUTS[layout_name]
        for name, shape in INPUT_SHAPES.items():
            got = dryrun.analytic_footprint(cfg, shape, lay)
            want = jax_dryrun.analytic_footprint(jcfg, J_SHAPES[name], _abstract_mesh(lay))
            assert got == {k: int(v) for k, v in want.items()}, (layout_name, name)


def test_footprint_of_h2o_decode_on_one_card():
    """h2o-danube-1.8b on one card: 33.42 GiB at decode_32k, its ring capping
    the cache at the 4,096-slot window for all 128 rows."""
    foot = dryrun.analytic_footprint(get_config("h2o-danube-1.8b"), INPUT_SHAPES["decode_32k"],
                                     LAYOUTS["1x1"])
    assert foot["state"] == 24 * 2 * 128 * 4096 * 8 * 80 * 2
    assert round(foot["total"] / 2**30, 2) == 33.42


# ---------------------------------------------------------------------------
# the roofline count and its depth extrapolation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,depth", [("h2o-danube-1.8b", 6), ("recurrentgemma-9b", 14)])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_depth_extrapolation_is_exact(arch, depth, kind):
    cfg = get_smoke_config(arch, n_layers=depth)
    shape = InputShape(kind, kind, 24, 2)
    est, how, depths, _ = dryrun.roofline_counts(cfg, shape)
    direct = dryrun.count_pair(steps.exec_config(cfg, shape, "roofline"), shape)
    assert how == ("hybrid" if arch == "recurrentgemma-9b" else "linear")
    for key in ("flops", "bytes"):
        assert est[key] == pytest.approx(direct[key], rel=1e-12), key
    assert direct["flops"] > 0 and direct["bytes"] > 0


def test_op_counter_counts_a_matmul():
    a = torch.empty((64, 32), device="meta")
    b = torch.empty((32, 16), device="meta")
    got = roofline.count_step(lambda x, y: (x @ y).t().contiguous(), a, b)
    assert got["flops"] == 2 * 64 * 32 * 16
    # mm reads a and b and writes its output; t() is a view; contiguous copies
    assert got["bytes"] == 4 * (64 * 32 + 32 * 16 + 64 * 16) + 4 * 2 * 64 * 16
    with pytest.raises(ValueError):
        roofline.count_step(lambda x: x, torch.zeros(2))


# ---------------------------------------------------------------------------
# far-position decode
# ---------------------------------------------------------------------------

def _random_state_np(jcfg, b, cap, seed):
    rng = np.random.default_rng(seed)
    st = jax.eval_shape(lambda: jmodel.init_state(jcfg, b, cap, jnp.float32))
    return jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.5).astype(s.dtype), st)


_PORT_TYPES = {"KVCache": attn.KVCache, "SSMState": ssm.SSMState,
               "RGLRUState": rglru.RGLRUState, "DecLayerState": encdec.DecLayerState}


def state_to_port(tree):
    """A JAX decode state (numpy leaves) -> the port's NamedTuples of tensors."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: state_to_port(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return _PORT_TYPES[type(tree).__name__](*(state_to_port(v) for v in tree))
    return torch.from_numpy(np.array(tree))


# The JAX decode step's own two forms at position 524,287 (smoke configs, f32,
# CPU): jitted against eager, logits apart by this much of ‖ref‖∞ (1.209e-3
# and 6.24e-5 measured). Under jit XLA computes RoPE's inverse frequencies
# 1 / theta^(i/half) one ulp apart from the eager (and the port's) values, and
# at 5.2e5 one ulp of a frequency is 1e-2 rad of angle; cos and sin themselves
# agree with float64 to 3e-8 in both packages.
JIT_EAGER_GAP = {"h2o-danube-1.8b": 2e-3, "recurrentgemma-9b": 1e-4}


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "recurrentgemma-9b"])
def test_far_position_decode_matches_reference(arch, capsys):
    """The decode step at position 524,287 (``long_500k``'s last) from a
    random full ring: logits and state against the JAX step run eagerly, at
    1e-5. The jitted JAX step differs from its eager self there
    (``JIT_EAGER_GAP``), so it is held only within that gap."""
    jcfg, cfg, backbone, adapters = _setup(arch, False)
    bb, adp = _port(cfg, backbone, adapters)
    jstate = _random_state_np(jcfg, B, FAR_POS + 1, seed=31)
    tok = np.random.default_rng(32).integers(0, cfg.vocab_size, (B,)).astype(np.int32)
    args = (backbone, adapters, jstate, jnp.asarray(tok), jnp.int32(FAR_POS))
    jlg, jnew = jsteps.make_decode_step(jcfg)(*args)
    jit_lg = np.asarray(jax.jit(jsteps.make_decode_step(jcfg))(*args)[0])
    lg, new = steps.make_decode_step(cfg)(bb, adp, state_to_port(jstate), torch.from_numpy(tok),
                                          torch.tensor(FAR_POS, dtype=torch.int32))
    assert rel_err(lg, np.asarray(jlg)) <= TOL
    assert_flat_close(port_flat(new), jax_flat(jnew), "state")
    jit_gap = rel_err(torch.from_numpy(np.asarray(jlg)), jit_lg)
    assert rel_err(lg, jit_lg) <= JIT_EAGER_GAP[arch]
    with capsys.disabled():
        print(f"\n[far-decode] {arch} at {FAR_POS}: port vs JAX eager "
              f"{rel_err(lg, np.asarray(jlg)):.3e}, JAX jit vs eager {jit_gap:.3e}")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

SMOKE_OVERRIDES = ["n_layers=2", "d_model=64", "n_heads=4", "n_kv_heads=1", "head_dim=16",
                   "d_ff=128", "vocab_size=256", "sliding_window=64"]


def test_dryrun_fit_all_on_cpu(capsys, tmp_path):
    assert dryrun.main(["--mode", "fit", "--shape", "all", "--arch", "all", "--layout", "1x1",
                        "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert ("[fit] h2o-danube-1.8b x decode_32k x 1x1: 33.42 GiB a card, analytic (TPU remat "
            "allowance): fits 80 GiB (") in out
    assert ("[fit] h2o-danube-1.8b x train_4k x 1x1: 43.43 GiB a card, analytic (TPU remat "
            "allowance): fits 80 GiB; --run measures the step's peak") in out
    assert "[skip] grok-1-314b x long_500k" in out
    assert (tmp_path / "h2o-danube-1.8b__train_4k__1x1__full.json").exists()


def test_dryrun_roofline_on_cpu(capsys, tmp_path):
    argv = ["--mode", "roofline", "--arch", "h2o-danube-1.8b", "--shape", "all", "--out",
            str(tmp_path), "--tag", "smoke"]
    for ov in SMOKE_OVERRIDES:
        argv += ["--override", ov]
    assert dryrun.main(argv) == 0
    out = capsys.readouterr().out
    assert out.count("[roofline] h2o-danube-1.8b") == 4
    rec = json.loads((tmp_path / "h2o-danube-1.8b__train_4k__1x1__roofline__smoke.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["collective_bytes"] is None
    assert rec["depth_points"]["depths"] == [2, 4]


def test_dryrun_run_on_cpu_when_asked(capsys):
    argv = ["--run", "--device", "cpu", "--arch", "h2o-danube-1.8b", "--shape", "long_500k"]
    for ov in SMOKE_OVERRIDES:
        argv += ["--override", ov]
    assert dryrun.main(argv) == 0
    out = capsys.readouterr().out
    assert "[run] h2o-danube-1.8b x long_500k on cpu: batch 1 (the global batch)" in out
    assert "peak not measured (CPU)" in out


def test_dryrun_rejects_unported_switch():
    with pytest.raises(ValueError, match="scan_layers"):
        dryrun.main(["--override", "scan_layers=false"])


def test_dryrun_remat_override_on_cpu(capsys, tmp_path):
    """``--override remat=false`` runs: the roofline's train count without
    the recompute below the default's, and a train step run on the CPU."""
    flops = {}
    for remat in ("true", "false"):
        argv = ["--mode", "roofline", "--arch", "h2o-danube-1.8b", "--shape", "train_4k",
                "--out", str(tmp_path), "--tag", remat, "--override", f"remat={remat}"]
        for ov in SMOKE_OVERRIDES:
            argv += ["--override", ov]
        assert dryrun.main(argv) == 0
        rec = json.loads((tmp_path / f"h2o-danube-1.8b__train_4k__1x1__roofline__{remat}.json")
                         .read_text())
        assert rec["status"] == "ok" and rec["overrides"]["remat"] is (remat == "true")
        flops[remat] = rec["hlo_flops"]
    assert flops["true"] > flops["false"]
    cfg = get_smoke_config("h2o-danube-1.8b")
    shape = InputShape("train", "train", 24, 2)
    rec = dryrun.run_record("h2o-danube-1.8b", cfg, cfg.with_(remat=False), shape,
                            dryrun.step_runner(cfg.with_(remat=False), shape,
                                               steps.backbone_specs(cfg, "cpu"),
                                               steps.adapter_specs(cfg, "cpu")),
                            2, "cpu", None, iters=1)
    assert not rec["remat"] and rec["transients"]["layer_inputs"] == 0
    assert "remat off" in dryrun.run_line(dict(rec, arch="h2o-danube-1.8b", shape="train",
                                               device="cpu"))


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "mamba2-130m"])
def test_roofline_counts_the_recompute(arch):
    """A train step's FLOPs with remat on, minus off, are one forward of the
    stack (counted on meta tensors) less each layer body's last matrix
    product: the recompute stops once it has rebuilt the last tensor the
    backward saved (``torch.utils.checkpoint``'s early stop), and the last
    product's output (the MLP's down projection, mamba2's out_proj) is not
    one of them, as XLA drops the same dead recompute under
    ``jax.checkpoint``."""
    cfg = get_smoke_config(arch)
    shape = InputShape("train", "train", 24, 2)
    on, off = (dryrun.count_pair(steps.exec_config(cfg.with_(remat=r), shape, "roofline"),
                                 shape)["flops"] for r in (True, False))
    x = torch.empty((2, 24, cfg.d_model), device="meta")
    positions = torch.arange(24, device="meta")[None].expand(2, 24)
    with roofline.OpCounter() as stack, torch.no_grad():
        transformer.forward_stack(cfg, steps.backbone_specs(cfg), x,
                                  make_angles(cfg, positions))
    inner = cfg.ssm.expand * cfg.d_model if cfg.family == "ssm" else cfg.d_ff
    last = 2 * 2 * 24 * inner * cfg.d_model
    assert stack.flops > 0 and on - off == stack.flops - cfg.n_layers * last
