"""The port's ssm family against the JAX package on smoke mamba2-130m.

The JAX package draws the weights; they reach the port through
``repro_torch.interop`` (tied embeddings: no ``unembed``; ``A_log``, ``D``
and ``dt_bias`` stacked (L, H)). Activations come from numpy seeds.
Sequence lengths cross the smoke config's 32-step chunks (40, 70), and a
2-token prompt is shorter than the conv window (d_conv - 1 = 3). Everything
runs in f32 on the CPU, where the port's SSD wrapper takes its plain
version, and agrees to 1e-5 of the reference's ∞-norm (``TOL``). The JAX
side runs ``ssm_apply`` with and without its Pallas kernel (interpret mode).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import model as jmodel
from repro.models import ssm as jssm
from repro_torch import interop
from repro_torch.configs import get_smoke_config
from repro_torch.models import model as model_lib
from repro_torch.models import ssm

ARCH = "mamba2-130m"
TOL = 1e-5
LENGTHS = [2, 40, 70]


def assert_close(got, want, tol=TOL, what=""):
    g = got.float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    err = float(np.max(np.abs(g - w)))
    bound = tol * float(np.max(np.abs(w)))
    assert err <= bound, f"{what}: max |err| {err:.3e} > {bound:.3e}"


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg = jax_smoke_config(ARCH)
    jparams = jmodel.init_backbone(jax.random.PRNGKey(0), jcfg)
    cfg = get_smoke_config(ARCH)
    params = interop.backbone_from_numpy(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, cfg, params


def _layer0(jparams, params):
    return jax.tree.map(lambda a: a[0], jparams["layers"]["ssm"]), params["layers"][0]["ssm"]


def _u(cfg, seed, seq, batch=2):
    u = np.random.default_rng(seed).standard_normal((batch, seq, cfg.d_model)).astype(np.float32)
    return jnp.asarray(u), torch.from_numpy(u)


def _tokens(cfg, seed, seq, batch=2):
    tok = np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    pos = np.tile(np.arange(seq, dtype=np.int32), (batch, 1))
    return ((jnp.asarray(tok), jnp.asarray(pos)),
            (torch.from_numpy(tok).long(), torch.from_numpy(pos).long()))


def test_backbone_is_tied_and_round_trips():
    _, jparams, cfg, params = _setup()
    assert "unembed" not in params and cfg.tie_embeddings
    assert params["layers"][1]["ssm"]["A_log"].shape == (ssm._dims(cfg)[1],)
    back = interop.backbone_to_numpy(params, cfg)
    flat_a = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jparams))[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_init_ssm_matches_reference_layout():
    """Shapes and the deterministic leaves of the port's own init."""
    _, jparams, cfg, _ = _setup()
    mine = model_lib.init_backbone(cfg, seed=0, device="cpu")
    ref = jax.tree.map(np.asarray, jparams)
    for name, want in ref["layers"]["ssm"].items():
        got = mine["layers"][0]["ssm"][name]
        assert tuple(got.shape) == want.shape[1:], name
    for name in ("A_log", "D", "conv_b", "norm_scale"):
        np.testing.assert_allclose(mine["layers"][0]["ssm"][name].numpy(),
                                   ref["layers"]["ssm"][name][0], rtol=1e-7)
    dt = torch.nn.functional.softplus(mine["layers"][0]["ssm"]["dt_bias"])
    assert bool(((dt > cfg.ssm.dt_min * 0.99) & (dt < cfg.ssm.dt_max * 1.01)).all())


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("seq", LENGTHS)
def test_ssm_apply(seq, use_pallas):
    jcfg, jparams, cfg, params = _setup()
    jp, tp = _layer0(jparams, params)
    ju, tu = _u(cfg, seq, seq)
    want = jssm.ssm_apply(jcfg, jp, ju, use_pallas=use_pallas)
    got = ssm.ssm_apply(cfg, tp, tu, use_pallas=use_pallas)
    assert_close(got, want, what="ssm_apply")


@pytest.mark.parametrize("seq,length", [(40, None), (70, None), (40, 2), (70, 37), (40, 33)])
def test_ssm_prefill_state(seq, length):
    """Output, conv window and terminal state, with the tail masked by
    ``length`` (2 is shorter than the conv window; 33 and 37 cross a chunk)."""
    jcfg, jparams, cfg, params = _setup()
    jp, tp = _layer0(jparams, params)
    ju, tu = _u(cfg, seq + 1, seq)
    jout, jst = jssm.ssm_prefill(jcfg, jp, ju, length=None if length is None else
                                 jnp.int32(length))
    for use_pallas in (False, True):
        out, st = ssm.ssm_prefill(cfg, tp, tu, length, use_pallas=use_pallas)
        assert_close(out, jout, what="prefill out")
        assert_close(st.conv, jst.conv, what="conv window")
        assert_close(st.h, jst.h, what="terminal h")
    if length is not None:  # the masked tail leaves the state of the unpadded prompt
        _, short = ssm.ssm_prefill(cfg, tp, tu[:, :length])
        assert_close(st.h, short.h.numpy(), tol=1e-6, what="h vs unpadded prompt")
        assert torch.equal(st.conv, short.conv)


def test_ssm_decode_step():
    jcfg, jparams, cfg, params = _setup()
    jp, tp = _layer0(jparams, params)
    _, H, conv_dim = ssm._dims(cfg)
    rng = np.random.default_rng(9)
    conv = rng.standard_normal((2, cfg.ssm.d_conv - 1, conv_dim)).astype(np.float32)
    h = rng.standard_normal((2, H, cfg.ssm.head_dim, cfg.ssm.d_state)).astype(np.float32)
    ju, tu = _u(cfg, 10, 1)
    jout, jst = jssm.ssm_decode_step(jcfg, jp, ju, jssm.SSMState(jnp.asarray(conv),
                                                                  jnp.asarray(h)))
    out, st = ssm.ssm_decode_step(cfg, tp, tu, ssm.SSMState(torch.from_numpy(conv),
                                                           torch.from_numpy(h)))
    assert_close(out, jout, what="decode out")
    assert_close(st.conv, jst.conv, what="decode conv")
    assert_close(st.h, jst.h, what="decode h")


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel"])
def test_model_forward_and_tied_logits(use_pallas):
    jcfg, jparams, cfg, params = _setup()
    jcfg, cfg = jcfg.with_(use_pallas=use_pallas), cfg.with_(use_pallas=use_pallas)
    (jt, jpos), (tt, tpos) = _tokens(cfg, 3, 70)
    jh, jaux = jmodel.forward(jcfg, jparams, jmodel.embed_tokens(jcfg, jparams, jt), jpos)
    th, taux = model_lib.forward(cfg, params, model_lib.embed_tokens(cfg, params, tt), tpos)
    assert_close(th, jh, what="hidden")
    assert float(taux) == float(jaux) == 0.0
    assert_close(model_lib.logits(cfg, params, th), jmodel.logits(jcfg, jparams, jh),
                 what="tied logits")


@pytest.mark.parametrize("length", [None, 2, 37])
def test_prefill_then_decode_logits(length):
    """Stacked state of model.prefill, then two decode steps through it."""
    jcfg, jparams, cfg, params = _setup()
    (jt, jpos), (tt, tpos) = _tokens(cfg, 4, 40)
    jst, jh = jmodel.prefill(jcfg, jparams, jmodel.embed_tokens(jcfg, jparams, jt), jpos, 48,
                             length=None if length is None else jnp.int32(length))
    tst, th = model_lib.prefill(cfg.with_(use_pallas=True), params,
                                model_lib.embed_tokens(cfg, params, tt), tpos, 48, length=length)
    assert_close(th, jh, what="prefill hidden")
    assert isinstance(tst["layers"], ssm.SSMState)
    assert tst["layers"].h.dtype == torch.float32 and tst["layers"].h.shape[0] == cfg.n_layers
    assert_close(tst["layers"].conv, jst["layers"].conv, what="stacked conv")
    assert_close(tst["layers"].h, jst["layers"].h, what="stacked h")
    pos = 40 if length is None else length
    for step, tok in enumerate(([[5], [9]], [[11], [3]])):
        t = np.asarray(tok, np.int32)
        jlg, jst = jmodel.decode_step(jcfg, jparams, jmodel.embed_tokens(jcfg, jparams,
                                                                          jnp.asarray(t)),
                                      jst, jnp.int32(pos + step))
        tlg, tst = model_lib.decode_step(cfg, params, model_lib.embed_tokens(
            cfg, params, torch.from_numpy(t).long()), tst, pos + step)
        assert_close(tlg, jlg, what=f"decode {step} logits")
        assert_close(tst["layers"].h, jst["layers"].h, what=f"decode {step} h")
