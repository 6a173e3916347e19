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
from repro_torch.kernels import harness
from repro_torch.kernels.fisher_merge import ops as fm_ops
from repro_torch.kernels.fisher_merge import ref as fm_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.lora import ops as lora_ops
from repro_torch.kernels.lora import ref as lora_ref

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
    assert harness.TOLERANCES == kernel_harness.TOLERANCES
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
