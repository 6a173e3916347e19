"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each wrapper of ``repro_torch.kernels`` runs its plain version;
it is held against the Pallas kernel run in interpret mode (as the JAX
package's own tests run it) over the shape grids of ``kernel_harness``, in
f32 and bf16, at ``kernel_harness.TOLERANCES``. Inputs come from numpy
seeds and are cast to the working dtype on both sides (both round to
nearest even), so the two sides see the same numbers.

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kernel_harness
from kernel_harness import FLASH_SHAPES, GROUPED_LORA_SHAPES, LORA_SHAPES, assert_close
from repro.kernels.flash_attention import flash_attention as jax_fa
from repro.kernels.lora import ops as jax_lora
from repro_torch.kernels import harness
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.lora import ops as lora_ops

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
    assert harness.TOLERANCES == kernel_harness.TOLERANCES


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
