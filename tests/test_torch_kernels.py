"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each wrapper of ``repro_torch.kernels`` runs its plain version;
it is held against the Pallas kernel run in interpret mode (as the JAX
package's own tests run it) over the shape grids of ``kernel_harness``, in
f32 and bf16, at ``kernel_harness.TOLERANCES``. Inputs come from numpy
seeds and are cast to the working dtype on both sides (both round to
nearest even), so the two sides see the same numbers.

The gradients of ``lora_residual`` and ``flash_attention`` (the port's
``autograd.Function``s) are held against ``jax.grad`` through the JAX
package's custom VJPs over the Pallas kernels in interpret mode, and against
``torch.autograd`` through the plain versions. The Fisher-merge wrappers are
held against the ``fisher_merge_2d`` / ``fisher_fold_2d`` Pallas kernels.

The SSD scan: the port's plain versions (``ssd_chunked``, the sequential
recurrence, the decode step) against the JAX package's oracles, its wrapper
against ``ssd_chunked_pallas`` in interpret mode, and the ``SSDScan``
gradients against ``jax.grad`` of the oracle ``ssd_chunked`` (the JAX
package cannot differentiate its Pallas kernel, so its training path
differentiates that oracle).

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kernel_harness
from kernel_harness import FLASH_SHAPES, GROUPED_LORA_SHAPES, LORA_SHAPES, assert_close
from repro.kernels.fisher_merge import ops as jax_fm
from repro.kernels.flash_attention import flash_attention as jax_fa
from repro.kernels.flash_attention import ops as jax_fa_ops
from repro.kernels.lora import ops as jax_lora
from repro.kernels.ssd_scan import ops as jax_ssd
from repro.kernels.ssd_scan import ref as jax_ssd_ref
from repro_torch.kernels import harness
from repro_torch.kernels.fisher_merge import ops as fm_ops
from repro_torch.kernels.fisher_merge import ref as fm_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.lora import ops as lora_ops
from repro_torch.kernels.lora import ref as lora_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref

DTYPES = ("float32", "bfloat16")
SCALE = 2.0


def _pair(a, dtype):
    """The same numbers as a JAX array and a torch tensor of ``dtype``."""
    return jnp.asarray(a).astype(dtype), torch.from_numpy(a).to(getattr(torch, dtype))


def _np(t):
    return t.float().cpu().numpy() if torch.is_tensor(t) else np.asarray(t, np.float32)


def _lora_inputs(seed, t, d, r, n=None):
    rng = np.random.default_rng(seed)
    lead = () if n is None else (n,)
    x = rng.standard_normal((t, d)).astype(np.float32)
    down = (rng.standard_normal(lead + (d, r)) * 0.05).astype(np.float32)
    up = (rng.standard_normal(lead + (r, d)) * 0.05).astype(np.float32)
    return x, down, up, rng


def _flash_inputs(seed, b, sq, sk, h, hkv, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d)))


def test_port_grids_are_the_harness_grids():
    """The port keeps its own copy of the grids and tolerances (it may not
    import the JAX package's test harness on the card)."""
    assert harness.LORA_SHAPES == kernel_harness.LORA_SHAPES
    assert harness.GROUPED_LORA_SHAPES == kernel_harness.GROUPED_LORA_SHAPES
    assert harness.FLASH_SHAPES == kernel_harness.FLASH_SHAPES
    assert harness.FISHER_SHAPES == kernel_harness.FISHER_SHAPES
    assert harness.SSD_SHAPES == kernel_harness.SSD_SHAPES
    assert harness.TOLERANCES == kernel_harness.TOLERANCES
    for dtype, tol in harness.SSD_TOLERANCES.items():
        assert tol == kernel_harness.tol_for("ssd_scan", getattr(jnp, dtype))
    for dtype, tol in harness.FLASH_GRAD_TOLERANCES.items():
        assert tol == kernel_harness.TOLERANCE_OVERRIDES[("flash_attention_grad", dtype)]


# ---------------------------------------------------------------------------
# plain versions (CPU) vs Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,d,r,bt", LORA_SHAPES)
def test_lora_matches_pallas(t, d, r, bt, dtype):
    x, down, up, _ = _lora_inputs(t * 1000 + d, t, d, r)
    (jx, tx), (jd, td), (ju, tu) = _pair(x, dtype), _pair(down, dtype), _pair(up, dtype)
    want = jax_lora.lora_residual(jx, jd, ju, scale=SCALE, block_t=bt, interpret=True)
    got = lora_ops.lora_residual(tx, td, tu, scale=SCALE)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert_close(_np(got), want, kernel="lora", dtype=dtype, err_msg=f"t{t}d{d}r{r}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,d,r,n,bt", GROUPED_LORA_SHAPES)
def test_grouped_lora_matches_pallas(t, d, r, n, bt, dtype):
    x, down, up, rng = _lora_inputs(t * 1000 + d + n, t, d, r, n)
    idx = rng.integers(-1, n, t).astype(np.int32)  # includes identity rows
    (jx, tx), (jd, td), (ju, tu) = _pair(x, dtype), _pair(down, dtype), _pair(up, dtype)
    want = jax_lora.grouped_lora_residual(jx, jd, ju, jnp.asarray(idx), scale=SCALE,
                                          block_t=bt, interpret=True)
    got = lora_ops.grouped_lora_residual(tx, td, tu, torch.from_numpy(idx), scale=SCALE)
    assert_close(_np(got), want, kernel="grouped_lora", dtype=dtype, err_msg=f"t{t}n{n}")
    ident = idx < 0
    assert torch.equal(got[torch.from_numpy(ident)], tx[torch.from_numpy(ident)])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=[s[0] for s in FLASH_SHAPES])
def test_flash_attention_matches_pallas(shape, dtype):
    label, b, sq, sk, h, hkv, d, causal, window, cap, bq, bk = shape
    arrays = _flash_inputs(len(label) * 7 + sq, b, sq, sk, h, hkv, d)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in arrays)
    want, want_lse = jax_fa.flash_attention(
        jq, jk, jv, causal=causal, window=window, softcap=cap, block_q=bq, block_k=bk,
        interpret=True, return_lse=True)
    got, got_lse = fa_ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                                          softcap=cap, return_lse=True)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert got_lse.dtype == torch.float32 and got_lse.shape == (b, sq, h)
    assert_close(_np(got), want, kernel="flash_attention", dtype=dtype, err_msg=label)
    assert_close(_np(got_lse), want_lse, kernel="flash_attention", dtype=dtype,
                 err_msg=f"{label} lse")


def test_flash_plain_version_guards_rows_without_keys():
    """Sq > Sk under the causal mask leaves the first rows with no key: the
    kernel's guard gives them 0 output and lse = NEG_INF."""
    q, k, v = (torch.from_numpy(a) for a in _flash_inputs(3, 1, 6, 4, 2, 2, 32))
    out, lse = fa_ref.attention(q, k, v, causal=True, return_lse=True)
    assert torch.equal(out[:, :2], torch.zeros_like(out[:, :2]))
    assert bool((lse[:, :2] == fa_ref.NEG_INF).all())
    assert bool(torch.isfinite(out).all())


def test_cpu_wrappers_count_no_launch():
    x, down, up, _ = _lora_inputs(0, 4, 32, 4)
    before = lora_ops.lora_residual.launches
    lora_ops.lora_residual(torch.from_numpy(x), torch.from_numpy(down),
                           torch.from_numpy(up), scale=SCALE)
    assert lora_ops.lora_residual.launches == before


# ---------------------------------------------------------------------------
# the bf16 tensor-core kernels' rounding models vs the exact plain versions
# ---------------------------------------------------------------------------

MODEL_LORA = (LORA_SHAPES + harness.FULL_LORA_SHAPES + harness.MAMBA_LORA_SHAPES
              + harness.LORA_EDGE_SHAPES + harness.FULL_LORA_GRAD_SHAPES[1:])
MODEL_FLASH = (FLASH_SHAPES + harness.FULL_FLASH_SHAPES + harness.FLASH_EDGE_SHAPES
               + harness.FULL_FLASH_GRAD_SHAPES)


def test_tf32_round_is_cvt_rna():
    """Nearest at 10 mantissa bits, ties away from zero, sign kept."""
    one_ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1 + one_ulp / 2, 1 + one_ulp * 1.5, -(1 + one_ulp / 2),
                      1 + one_ulp / 2 - 2.0 ** -23, 3.0e-39, 0.0])
    want = torch.tensor([1.0, 1 + one_ulp, 1 + 2 * one_ulp, -(1 + one_ulp), 1.0,
                         float(np.float32(3.0e-39)), 0.0])
    got = lora_ref.tf32_round(x)
    assert torch.equal(got[:5], want[:5])
    assert torch.equal(got[6:], want[6:])
    hi, lo = lora_ref.split_tf32(torch.tensor([0.1, -7.3e-5, 1234.567]))
    assert torch.equal(lora_ref.tf32_round(hi), hi) and torch.equal(lora_ref.tf32_round(lo), lo)
    assert float(((hi + lo) - torch.tensor([0.1, -7.3e-5, 1234.567])).abs().max()) <= \
        2.0 ** -22 * 1234.567


@pytest.mark.parametrize("t,d,r,bt", MODEL_LORA)
def test_lora_split_tf32_model_holds_f32_tolerance(t, d, r, bt):
    """Split TF32 (bf16 x exact; f32 adapters and h as hi + lo) against the
    exact f32 plain version at the f32 tolerance, 1e-6 (chip_smoke.py's
    [accuracy] lines print the gap at the main-path shapes)."""
    x, down, up, _ = _lora_inputs(t + d, t, d, r)
    xb = torch.from_numpy(x).to(torch.bfloat16).float()  # bf16 values, held in f32
    down, up = torch.from_numpy(down), torch.from_numpy(up)
    got = lora_ref.lora_residual_split_tf32(xb, down, up, scale=SCALE)
    harness.check_close(got, lora_ref.lora_residual(xb, down, up, scale=SCALE), "float32",
                        f"split-tf32 model t{t}d{d}r{r}")


@pytest.mark.parametrize("t,d,r,bt", harness.FULL_LORA_SHAPES + harness.MAMBA_LORA_SHAPES)
def test_lora_model_share_tells_designs_apart(t, d, r, bt):
    """harness.LORA_MODEL_MAX_SHARE, the share of bf16 outputs that may differ
    from the split-TF32 model, passes the exact f32 arithmetic and fails the
    designs that drop adapter bits (single-pass TF32, bf16 adapters), so
    the card's check of the kernel against its model has teeth."""
    x, down, up, _ = _lora_inputs(t * 7 + d, t, d, r)
    x = torch.from_numpy(x).to(torch.bfloat16)
    down, up = torch.from_numpy(down), torch.from_numpy(up)
    model = lora_ref.lora_residual_split_tf32(x, down, up, scale=SCALE)
    limit = harness.LORA_MODEL_MAX_SHARE
    harness.check_share(lora_ref.lora_residual(x, down, up, scale=SCALE), model, limit,
                        f"exact f32 t{t}d{d}r{r}")
    others = {"single-pass TF32": lora_ref.lora_residual_tf32(x, down, up, scale=SCALE),
              "bf16 adapters": lora_ref.lora_residual(x, down.bfloat16().float(),
                                                      up.bfloat16().float(), scale=SCALE)}
    for name, y in others.items():
        with pytest.raises(AssertionError, match="elements differ"):
            harness.check_share(y, model, limit, f"{name} t{t}d{d}r{r}")


@pytest.mark.parametrize("shape", MODEL_FLASH, ids=[s[0] for s in MODEL_FLASH])
def test_flash_bf16_model_holds_bf16_tolerance(shape):
    """P rounded to bf16 before P·V (l and the LSE from the f32 p) against
    the exact plain version in bf16, at the bf16 tolerance (chip_smoke.py's
    [accuracy] lines print the gap at the main-path shapes); the LSE is
    identical."""
    label, b, sq, sk, h, hkv, d, causal, window, cap, _, _ = shape
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _flash_inputs(sq * 31 + d, b, sq, sk, h, hkv, d))
    kw = dict(causal=causal, window=window, softcap=cap, return_lse=True)
    got, got_lse = fa_ref.attention_bf16_model(q, k, v, **kw)
    want, want_lse = fa_ref.attention(q, k, v, **kw)
    harness.check_close(got, want, "bfloat16", f"bf16 model {label}")
    harness.check_close(got_lse, want_lse, "float32", f"bf16 model {label} lse")


# ---------------------------------------------------------------------------
# gradients: the autograd.Functions vs jax.grad through the custom VJPs
# ---------------------------------------------------------------------------

def _sq_loss_grads_torch(fn, *tensors):
    """grads of sum(fn(*tensors)²) (in f32) by torch.autograd."""
    leaves = [t.detach().clone().requires_grad_(True) for t in tensors]
    (fn(*leaves).float() ** 2).sum().backward()
    return [t.grad for t in leaves]


def _sq_loss_grads_jax(fn, *arrays):
    return jax.grad(lambda *a: jnp.sum(fn(*a).astype(jnp.float32) ** 2),
                    argnums=tuple(range(len(arrays))))(*arrays)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,d,r,bt", harness.LORA_GRAD_SHAPES)
def test_lora_grad_matches_pallas_vjp_and_autograd(t, d, r, bt, dtype):
    """dx, dA, dB: x in the working dtype, f32 adapters (the NanoAdapter layout)."""
    x, down, up, _ = _lora_inputs(t * 7 + r, t, d, r)
    (jx, tx) = _pair(x, dtype)
    jd, ju = jnp.asarray(down), jnp.asarray(up)
    td, tu = torch.from_numpy(down), torch.from_numpy(up)
    want = _sq_loss_grads_jax(
        lambda a, b, c: jax_lora.lora_residual(a, b, c, scale=SCALE, block_t=bt, interpret=True),
        jx, jd, ju)
    got = _sq_loss_grads_torch(lambda a, b, c: lora_ops.lora_residual(a, b, c, scale=SCALE),
                               tx, td, tu)
    plain = _sq_loss_grads_torch(lambda a, b, c: lora_ref.lora_residual(a, b, c, scale=SCALE),
                                 tx, td, tu)
    for name, g, w, p in zip(("dx", "dA", "dB"), got, want, plain):
        assert g.dtype == (tx.dtype if name == "dx" else torch.float32)
        assert_close(_np(g), w, kernel="lora", dtype=dtype, err_msg=f"{name} vs Pallas VJP")
        assert_close(_np(g), _np(p), kernel="lora", dtype=dtype, err_msg=f"{name} vs autograd")


def test_lora_backward_skips_dx_for_frozen_x():
    """FedNano's x is frozen: the backward asks for no dx."""
    x, down, up, _ = _lora_inputs(1, 6, 32, 4)
    tx = torch.from_numpy(x)
    td, tu = (torch.from_numpy(a).requires_grad_(True) for a in (down, up))
    lora_ops.lora_residual(tx, td, tu, scale=SCALE).sum().backward()
    assert tx.grad is None and td.grad is not None and tu.grad is not None


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", harness.FLASH_GRAD_SHAPES,
                         ids=[s[0] for s in harness.FLASH_GRAD_SHAPES])
def test_flash_grad_matches_pallas_vjp_and_autograd(shape, dtype):
    """dq, dk, dv: causal, window, softcap, GQA/MQA, Sq < Sk, bidirectional
    and rows that see no key, at the harness's flash-gradient tolerance."""
    label, b, sq, sk, h, hkv, d, causal, window, cap, bq, bk = shape
    arrays = _flash_inputs(len(label) * 11 + sk, b, sq, sk, h, hkv, d)
    pairs = [_pair(a, dtype) for a in arrays]
    kw = dict(causal=causal, window=window, softcap=cap)
    want = _sq_loss_grads_jax(
        lambda q, k, v: jax_fa_ops.flash_attention(q, k, v, block_q=bq, block_k=bk,
                                                   interpret=True, **kw),
        *(p[0] for p in pairs))
    tensors = [p[1] for p in pairs]
    got = _sq_loss_grads_torch(lambda q, k, v: fa_ops.flash_attention(q, k, v, **kw), *tensors)
    plain = _sq_loss_grads_torch(lambda q, k, v: fa_ref.attention(q, k, v, **kw), *tensors)
    for name, g, w, p in zip(("dq", "dk", "dv"), got, want, plain):
        assert g.dtype == tensors[0].dtype and bool(torch.isfinite(g).all())
        assert_close(_np(g), w, kernel="flash_attention_grad", dtype=dtype,
                     err_msg=f"{label} {name} vs Pallas VJP")
        assert_close(_np(g), _np(p), kernel="flash_attention_grad", dtype=dtype,
                     err_msg=f"{label} {name} vs autograd")


# ---------------------------------------------------------------------------
# Fisher merge and fold vs fisher_merge_2d / fisher_fold_2d
# ---------------------------------------------------------------------------

FISHER = harness.FISHER_SHAPES + harness.FISHER_EXTRA_SHAPES


def _fisher_inputs(seed, k, n):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((k, n)).astype(np.float32)
    f = rng.uniform(0.01, 1.0, (k, n)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, k).astype(np.float32)
    return t, f, w


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,n,bn", FISHER)
def test_fisher_merge_matches_pallas(k, n, bn, dtype):
    t, f, w = _fisher_inputs(k * 1000 + n, k, n)
    (jt, tt), (jf, tf) = _pair(t, dtype), _pair(f, dtype)
    want = jax_fm.fisher_merge(jt, jf, jnp.asarray(w), block_n=bn, interpret=True)
    got = fm_ops.fisher_merge(tt, tf, torch.from_numpy(w))
    assert got.dtype == tt.dtype and got.shape == (n,)
    assert_close(_np(got), want, kernel="fisher_merge", dtype=dtype, err_msg=f"k{k}n{n}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,n,bn", FISHER)
def test_fisher_fold_matches_pallas_and_batch_merge(k, n, bn, dtype):
    """Fold every client in turn (in place), then finalize: each step equals the
    Pallas fold, and the result equals the batch merge to f32 summation order."""
    t, f, w = _fisher_inputs(k * 999 + n, k, n)
    (jt, tt), (jf, tf) = _pair(t, dtype), _pair(f, dtype)
    jnum = jden = jnp.zeros((n,), jnp.float32)
    num, den = torch.zeros(n), torch.zeros(n)
    for i in range(k):
        jnum, jden = jax_fm.fisher_fold(jnum, jden, jt[i], jf[i], jnp.float32(w[i]),
                                        block_n=bn, interpret=True)
        got_num, got_den = fm_ops.fisher_fold(num, den, tt[i], tf[i], float(w[i]))
        assert got_num is num and got_den is den  # in place
        assert_close(_np(num), jnum, kernel="fisher_merge_stream", dtype="float32",
                     err_msg=f"num after client {i}")
        assert_close(_np(den), jden, kernel="fisher_merge_stream", dtype="float32",
                     err_msg=f"den after client {i}")
    merged = fm_ref.fisher_merge(tt, tf, torch.from_numpy(w))
    assert_close(_np((num / (den + 1e-8)).to(tt.dtype)), _np(merged),
                 kernel="fisher_merge_stream", dtype=dtype, err_msg="finalized vs batch")


# ---------------------------------------------------------------------------
# SSD chunked scan vs ssd_chunked_pallas and the jnp oracles
# ---------------------------------------------------------------------------

def _ssd_inputs(seed, b, s, h, p, n):
    """The harness's input scales (``kernel_harness._ssd_args``) from numpy."""
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((b, s, h, p)) * 0.5).astype(np.float32),
            rng.uniform(0.01, 0.2, (b, s, h)).astype(np.float32),
            -rng.uniform(0.5, 2.0, h).astype(np.float32),
            (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32),
            (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32))


def _ssd_pairs(arrays, dtype):
    """x, dt, B, C in ``dtype``; A stays f32 (the model's layout)."""
    x, dt, A, B, C = arrays
    pairs = [_pair(a, dtype) for a in (x, dt, B, C)]
    jA, tA = jnp.asarray(A), torch.from_numpy(A)
    return ([pairs[0][0], pairs[1][0], jA, pairs[2][0], pairs[3][0]],
            [pairs[0][1], pairs[1][1], tA, pairs[2][1], pairs[3][1]])


@pytest.mark.parametrize("b,s,h,p,n,q", harness.SSD_SHAPES)
def test_ssd_plain_versions_match_reference(b, s, h, p, n, q):
    """ssd_chunked, the sequential recurrence and the decode step, f32."""
    j, t = _ssd_pairs(_ssd_inputs(s * 10 + p, b, s, h, p, n), "float32")
    for name, got, want in (
            ("ssd_chunked", ssd_ref.ssd_chunked(*t, chunk=q), jax_ssd_ref.ssd_chunked(*j, q)),
            ("sequential", ssd_ref.ssd_reference_sequential(*t),
             jax_ssd_ref.ssd_reference_sequential(*j))):
        assert got.dtype == torch.float32 and got.shape == (b, s, h, p)
        assert_close(_np(got), want, kernel="ssd_scan", dtype="float32", err_msg=name)
    rng = np.random.default_rng(s)
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    want_y, want_h = jax_ssd_ref.ssd_decode_step(jnp.asarray(h0), *(a[:, 0] for a in j[:2]),
                                                 j[2], *(a[:, 0] for a in j[3:]))
    got_y, got_h = ssd_ref.ssd_decode_step(torch.from_numpy(h0), *(a[:, 0] for a in t[:2]),
                                           t[2], *(a[:, 0] for a in t[3:]))
    assert_close(_np(got_y), want_y, kernel="ssd_scan", dtype="float32", err_msg="decode y")
    assert_close(_np(got_h), want_h, kernel="ssd_scan", dtype="float32", err_msg="decode h")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,h,p,n,q", harness.SSD_SHAPES)
def test_ssd_matches_pallas(b, s, h, p, n, q, dtype):
    j, t = _ssd_pairs(_ssd_inputs(s * 7 + n, b, s, h, p, n), dtype)
    want = jax_ssd.ssd(*j, chunk=q, interpret=True)
    before = ssd_ops.ssd.launches
    got = ssd_ops.ssd(*t, chunk=q)
    assert ssd_ops.ssd.launches == before  # the plain version on the CPU
    assert got.dtype == t[0].dtype and got.shape == t[0].shape
    assert_close(_np(got), want, kernel="ssd_scan", dtype=dtype, err_msg=f"b{b}s{s}q{q}")


@pytest.mark.parametrize("b,s,h,p,n,q", harness.SSD_SHAPES)
def test_ssd_grad_matches_jax_grad_of_oracle(b, s, h, p, n, q):
    """dx, ddt, dA, dB, dC of SSDScan (f32) against jax.grad through
    ``ssd_chunked`` and torch.autograd through the port's plain version."""
    j, t = _ssd_pairs(_ssd_inputs(s * 3 + h, b, s, h, p, n), "float32")
    want = _sq_loss_grads_jax(lambda *a: jax_ssd_ref.ssd_chunked(*a, q), *j)
    got = _sq_loss_grads_torch(lambda *a: ssd_ops.ssd(*a, chunk=q), *t)
    plain = _sq_loss_grads_torch(lambda *a: ssd_ref.ssd_chunked(*a, chunk=q), *t)
    for name, g, w, pl in zip(("dx", "ddt", "dA", "dB", "dC"), got, want, plain):
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
        assert_close(_np(g), w, kernel="ssd_scan", dtype="float32", err_msg=f"{name} vs jax")
        assert_close(_np(g), _np(pl), kernel="ssd_scan", dtype="float32",
                     err_msg=f"{name} vs autograd")


def test_ssd_grad_only_for_inputs_that_need_it():
    """A frozen A (the model's parameter) gets no gradient."""
    _, t = _ssd_pairs(_ssd_inputs(0, 1, 20, 2, 16, 8), "float32")
    x = t[0].clone().requires_grad_(True)
    ssd_ops.ssd(x, t[1], t[2], t[3], t[4], chunk=16).sum().backward()
    assert x.grad is not None and t[2].grad is None
