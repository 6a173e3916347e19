"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without an NVIDIA card every test skips. The file imports
neither JAX nor the JAX package, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: ``tests/conftest.py`` configures JAX.) Grids and
tolerances are ``repro_torch.kernels.harness``, the port's copy of the JAX
package's ``tests/kernel_harness.py``, plus the full-width llava-1.5-7b and
mamba2-130m shapes. The gradients of ``lora_residual``, ``flash_attention``
and ``ssd`` (kernel forward, hand-written or recomputed backward) are held
against ``torch.autograd`` through the plain versions; the Fisher-merge and
SSD kernels against their plain versions.
"""
import pytest
import torch

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
LORA = harness.LORA_SHAPES + harness.FULL_LORA_SHAPES + harness.MAMBA_LORA_SHAPES
GROUPED = harness.GROUPED_LORA_SHAPES + harness.FULL_GROUPED_SHAPES + harness.MAMBA_GROUPED_SHAPES
FLASH = harness.FLASH_SHAPES + harness.FULL_FLASH_SHAPES
LORA_EDGE = harness.LORA_EDGE_SHAPES
FLASH_EDGE = harness.FLASH_EDGE_SHAPES
# the bf16 tensor-core kernels against their rounding models
LORA_MODEL = LORA + LORA_EDGE + harness.FULL_LORA_GRAD_SHAPES[1:]
FLASH_MODEL = FLASH + FLASH_EDGE + harness.FULL_FLASH_GRAD_SHAPES
LORA_GRAD = (harness.LORA_GRAD_SHAPES + harness.FULL_LORA_GRAD_SHAPES
             + harness.MAMBA_LORA_GRAD_SHAPES)
FLASH_GRAD = harness.FLASH_GRAD_SHAPES + harness.FULL_FLASH_GRAD_SHAPES
FISHER = (harness.FISHER_SHAPES + harness.FISHER_EXTRA_SHAPES + harness.FULL_FISHER_SHAPES
          + harness.MAMBA_FISHER_SHAPES)
SSD = harness.SSD_SHAPES + harness.FULL_SSD_SHAPES


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, shape, scale=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=gen, device=gen.device) * scale).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,d,r,bt", LORA)
def test_lora_kernel_matches_plain(cuda, t, d, r, bt, dtype):
    gen = torch.Generator(device=cuda).manual_seed(t + d)
    x = _randn(gen, (t, d), dtype=getattr(torch, dtype))
    down, up = _randn(gen, (d, r), 0.05), _randn(gen, (r, d), 0.05)
    got = lora_ops.lora_residual(x, down, up, scale=SCALE)
    want = lora_ref.lora_residual(x, down, up, scale=SCALE)
    torch.cuda.synchronize()
    harness.check_close(got, want, dtype, f"lora t{t}d{d}r{r}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,d,r,n,bt", GROUPED)
def test_grouped_lora_kernel_matches_plain(cuda, t, d, r, n, bt, dtype):
    gen = torch.Generator(device=cuda).manual_seed(t + d + n)
    x = _randn(gen, (t, d), dtype=getattr(torch, dtype))
    down, up = _randn(gen, (n, d, r), 0.05), _randn(gen, (n, r, d), 0.05)
    idx = torch.randint(-1, n, (t,), generator=gen, device=cuda, dtype=torch.int32)
    got = lora_ops.grouped_lora_residual(x, down, up, idx, scale=SCALE)
    want = lora_ref.grouped_lora_residual(x, down, up, idx, scale=SCALE)
    torch.cuda.synchronize()
    harness.check_close(got, want, dtype, f"grouped t{t}d{d}n{n}")
    assert torch.equal(got[idx < 0], x[idx < 0])  # identity rows, bit for bit
    if dtype == "float32":  # each row equals the single-adapter kernel's row
        for a in range(n):
            single = lora_ops.lora_residual(x, down[a], up[a], scale=SCALE)
            assert torch.equal(got[idx == a], single[idx == a]), a


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", FLASH, ids=[s[0] for s in FLASH])
def test_flash_kernel_matches_plain(cuda, shape, dtype):
    label, b, sq, sk, h, hkv, d, causal, window, cap, _, _ = shape
    gen = torch.Generator(device=cuda).manual_seed(sq * 31 + d)
    q = _randn(gen, (b, sq, h, d), dtype=getattr(torch, dtype))
    k = _randn(gen, (b, sk, hkv, d), dtype=getattr(torch, dtype))
    v = _randn(gen, (b, sk, hkv, d), dtype=getattr(torch, dtype))
    got, got_lse = fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                          softcap=cap, return_lse=True)
    want, want_lse = fa_ref.attention(q, k, v, causal=causal, window=window, softcap=cap,
                                      return_lse=True)
    torch.cuda.synchronize()
    harness.check_close(got, want, dtype, label)
    harness.check_close(got_lse, want_lse, dtype, f"{label} lse")


def _flash_qkv(gen, shape, dtype):
    label, b, sq, sk, h, hkv, d, causal, window, cap, _, _ = shape
    dt = getattr(torch, dtype)
    q = _randn(gen, (b, sq, h, d), dtype=dt)
    k, v = _randn(gen, (b, sk, hkv, d), dtype=dt), _randn(gen, (b, sk, hkv, d), dtype=dt)
    return (q, k, v), dict(causal=causal, window=window, softcap=cap)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", FLASH_EDGE, ids=[s[0] for s in FLASH_EDGE])
def test_flash_kernel_tile_edges_match_plain(cuda, shape, dtype):
    """Sq and Sk around the bf16 kernel's 64-row and 64-key tiles, Sq != Sk,
    head dims 32 and 256, window, softcap and decode; rows that see no key
    (whole tiles of them) give exactly 0 and lse = NEG_INF."""
    gen = torch.Generator(device=cuda).manual_seed(shape[2] * 131 + shape[3] + shape[6])
    qkv, kw = _flash_qkv(gen, shape, dtype)
    got, got_lse = fa_ops.flash_attention(*qkv, return_lse=True, **kw)
    want, want_lse = fa_ref.attention(*qkv, return_lse=True, **kw)
    torch.cuda.synchronize()
    harness.check_close(got, want, dtype, shape[0])
    harness.check_close(got_lse, want_lse, dtype, f"{shape[0]} lse")
    sq, sk = shape[2], shape[3]
    dead = ~fa_ref.attention_mask(sq, sk, causal=kw["causal"], window=kw["window"],
                                  device=cuda).any(dim=-1)
    assert torch.equal(got[:, dead], torch.zeros_like(got[:, dead]))
    assert bool((got_lse[:, dead] == fa_ref.NEG_INF).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FLASH_MODEL, ids=[s[0] for s in FLASH_MODEL])
def test_flash_bf16_kernel_matches_its_model(cuda, shape):
    """The bf16 tensor-core kernel against ref.attention_bf16_model (P in
    bf16) at harness.BF16_MODEL_TOLERANCES; the LSE, which both sum from
    the f32 p, at the f32 tolerance."""
    gen = torch.Generator(device=cuda).manual_seed(shape[2] * 7 + shape[6])
    qkv, kw = _flash_qkv(gen, shape, "bfloat16")
    got, got_lse = fa_ops.flash_attention(*qkv, return_lse=True, **kw)
    want, want_lse = fa_ref.attention_bf16_model(*qkv, return_lse=True, **kw)
    torch.cuda.synchronize()
    harness.check_close(got, want, "bfloat16", f"{shape[0]} vs model",
                        harness.BF16_MODEL_TOLERANCES)
    harness.check_close(got_lse, want_lse, "float32", f"{shape[0]} lse vs model")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,d,r,bt", LORA_EDGE)
def test_lora_kernel_ragged_edges_match_plain(cuda, t, d, r, bt, dtype):
    """T off the 64-row tile, D and r off multiples of 8 and 16 (element and
    4-byte copies instead of 16-byte ones), rank 129 and 256."""
    gen = torch.Generator(device=cuda).manual_seed(t * 5 + d + r)
    x = _randn(gen, (t, d), dtype=getattr(torch, dtype))
    down, up = _randn(gen, (d, r), 0.05), _randn(gen, (r, d), 0.05)
    got = lora_ops.lora_residual(x, down, up, scale=SCALE)
    want = lora_ref.lora_residual(x, down, up, scale=SCALE)
    torch.cuda.synchronize()
    harness.check_close(got, want, dtype, f"lora edge t{t}d{d}r{r}")


@pytest.mark.cuda
@pytest.mark.parametrize("t,d,r,bt", LORA_MODEL)
def test_lora_bf16_kernel_matches_its_model(cuda, t, d, r, bt):
    """The bf16 tensor-core kernel against ref.lora_residual_split_tf32 at
    harness.BF16_MODEL_TOLERANCES, with at most harness.LORA_MODEL_MAX_SHARE
    of the elements differing."""
    gen = torch.Generator(device=cuda).manual_seed(t * 3 + d + r)
    x = _randn(gen, (t, d), dtype=torch.bfloat16)
    down, up = _randn(gen, (d, r), 0.05), _randn(gen, (r, d), 0.05)
    got = lora_ops.lora_residual(x, down, up, scale=SCALE)
    want = lora_ref.lora_residual_split_tf32(x, down, up, scale=SCALE)
    torch.cuda.synchronize()
    harness.check_close(got, want, "bfloat16", f"lora t{t}d{d}r{r} vs model",
                        harness.BF16_MODEL_TOLERANCES)
    harness.check_share(got, want, harness.LORA_MODEL_MAX_SHARE, f"lora t{t}d{d}r{r} vs model")


@pytest.mark.cuda
def test_flash_kernel_rejects_head_dim(cuda):
    q = torch.zeros((1, 4, 2, 96), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa_ops.flash_attention(q, q, q)


@pytest.mark.cuda
def test_wrappers_count_launches(cuda):
    x = torch.zeros((4, 32), device=cuda)
    a, b = torch.zeros((32, 4), device=cuda), torch.zeros((4, 32), device=cuda)
    before = lora_ops.lora_residual.launches
    lora_ops.lora_residual(x, a, b, scale=SCALE)
    assert lora_ops.lora_residual.launches == before + 1


def _grads(fn, *tensors):
    """grads of sum(fn(*tensors)²) (in f32) by torch.autograd."""
    leaves = [t.detach().clone().requires_grad_(True) for t in tensors]
    (fn(*leaves).float() ** 2).sum().backward()
    return [t.grad for t in leaves]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,d,r,bt", LORA_GRAD)
def test_lora_grad_matches_plain(cuda, t, d, r, bt, dtype):
    gen = torch.Generator(device=cuda).manual_seed(t * 3 + r)
    x = _randn(gen, (t, d), dtype=getattr(torch, dtype))
    down, up = _randn(gen, (d, r), 0.05), _randn(gen, (r, d), 0.05)
    got = _grads(lambda a, b, c: lora_ops.lora_residual(a, b, c, scale=SCALE), x, down, up)
    want = _grads(lambda a, b, c: lora_ref.lora_residual(a, b, c, scale=SCALE), x, down, up)
    torch.cuda.synchronize()
    for name, g, w in zip(("dx", "dA", "dB"), got, want):
        harness.check_close(g, w, dtype, f"lora grad {name} t{t}d{d}r{r}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", FLASH_GRAD, ids=[s[0] for s in FLASH_GRAD])
def test_flash_grad_matches_plain(cuda, shape, dtype):
    label, b, sq, sk, h, hkv, d, causal, window, cap, _, _ = shape
    gen = torch.Generator(device=cuda).manual_seed(sk * 17 + d)
    dt = getattr(torch, dtype)
    q, k, v = (_randn(gen, s, dtype=dt) for s in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d)))
    kw = dict(causal=causal, window=window, softcap=cap)
    got = _grads(lambda *a: fa_ops.flash_attention(*a, **kw), q, k, v)
    want = _grads(lambda *a: fa_ref.attention(*a, **kw), q, k, v)
    torch.cuda.synchronize()
    tol = (harness.FULL_FLASH_GRAD_TOLERANCES if shape in harness.FULL_FLASH_GRAD_SHAPES
           else harness.FLASH_GRAD_TOLERANCES)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        harness.check_close(g, w, dtype, f"flash grad {name} {label}", tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,n,bn", FISHER)
def test_fisher_kernels_match_plain(cuda, k, n, bn, dtype):
    gen = torch.Generator(device=cuda).manual_seed(k * 1000 + n)
    dt = getattr(torch, dtype)
    theta = _randn(gen, (k, n), dtype=dt)
    fisher = (torch.rand((k, n), generator=gen, device=cuda) + 0.01).to(dt)
    w = torch.rand((k,), generator=gen, device=cuda) + 0.1
    got = fm_ops.fisher_merge(theta, fisher, w)
    harness.check_close(got, fm_ref.fisher_merge(theta, fisher, w), dtype, f"merge k{k}n{n}")
    num, den = torch.zeros(n, device=cuda), torch.zeros(n, device=cuda)
    pnum, pden = num.clone(), den.clone()
    for i in range(k):
        fm_ops.fisher_fold(num, den, theta[i], fisher[i], float(w[i]))
        fm_ref.fisher_fold(pnum, pden, theta[i], fisher[i], float(w[i]))
    torch.cuda.synchronize()
    harness.check_close(num, pnum, "float32", f"fold num k{k}n{n}")
    harness.check_close(den, pden, "float32", f"fold den k{k}n{n}")


def _ssd_tol(*shape):
    full = shape in harness.FULL_SSD_SHAPES
    return harness.FULL_SSD_TOLERANCES if full else harness.SSD_TOLERANCES


def _ssd_inputs(gen, b, s, h, p, n, dtype):
    """The JAX harness's input scales: x·0.5, dt in [0.01, 0.2), A in (-2, -0.5]."""
    x = _randn(gen, (b, s, h, p), 0.5, dtype)
    dt = (torch.rand((b, s, h), generator=gen, device=gen.device) * 0.19 + 0.01).to(dtype)
    A = -(torch.rand((h,), generator=gen, device=gen.device) * 1.5 + 0.5)
    return x, dt, A, _randn(gen, (b, s, n), 0.3, dtype), _randn(gen, (b, s, n), 0.3, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,h,p,n,q", SSD)
def test_ssd_kernel_matches_plain(cuda, b, s, h, p, n, q, dtype):
    gen = torch.Generator(device=cuda).manual_seed(s * 13 + n)
    args = _ssd_inputs(gen, b, s, h, p, n, getattr(torch, dtype))
    before = ssd_ops.ssd.launches
    got = ssd_ops.ssd(*args, chunk=q)
    want = ssd_ref.ssd_chunked(*args, chunk=q)
    torch.cuda.synchronize()
    assert ssd_ops.ssd.launches == before + 1
    harness.check_close(got, want, dtype, f"ssd b{b}s{s}h{h}p{p}n{n}q{q}",
                        _ssd_tol(b, s, h, p, n, q))


@pytest.mark.cuda
def test_ssd_kernel_takes_strided_views(cuda):
    """x, B and C as slices of one projection, as the model passes them."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    b, s, h, p, n = 2, 70, 3, 32, 16
    xbc = _randn(gen, (b, s, h * p + 2 * n), 0.4)
    x, B, C = xbc[..., :h * p].reshape(b, s, h, p), xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    _, dt, A, _, _ = _ssd_inputs(gen, b, s, h, p, n, torch.float32)
    got = ssd_ops.ssd(x, dt, A, B, C, chunk=32)
    want = ssd_ref.ssd_chunked(x, dt, A, B, C, chunk=32)
    torch.cuda.synchronize()
    harness.check_close(got, want, "float32", "ssd strided", harness.SSD_TOLERANCES)


@pytest.mark.cuda
def test_ssd_kernel_rejects_wide_state(cuda):
    x = torch.zeros((1, 8, 2, 16), device=cuda)
    dt, A = torch.zeros((1, 8, 2), device=cuda), torch.zeros((2,), device=cuda)
    B = torch.zeros((1, 8, ssd_ops.MAX_N + 1), device=cuda)
    with pytest.raises(ValueError, match="N"):
        ssd_ops.ssd(x, dt, A, B, B, chunk=8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,h,p,n,q", SSD)
def test_ssd_grad_matches_plain(cuda, b, s, h, p, n, q, dtype):
    gen = torch.Generator(device=cuda).manual_seed(s * 7 + p)
    args = _ssd_inputs(gen, b, s, h, p, n, getattr(torch, dtype))
    got = _grads(lambda *a: ssd_ops.ssd(*a, chunk=q), *args)
    want = _grads(lambda *a: ssd_ref.ssd_chunked(*a, chunk=q), *args)
    torch.cuda.synchronize()
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        harness.check_close(g, w, dtype, f"ssd grad {name} b{b}s{s}q{q}",
                            _ssd_tol(b, s, h, p, n, q))
