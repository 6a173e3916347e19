"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without an NVIDIA card every test skips. The file imports
neither JAX nor the JAX package, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: ``tests/conftest.py`` configures JAX.) Grids and
tolerances are ``repro_torch.kernels.harness``, the port's copy of the JAX
package's ``tests/kernel_harness.py``, plus the full-width shapes of
llava-1.5-7b, mamba2-130m, the dense family, the MoE family and qwen2-vl-72b
(grok-1's attention softcap of 30 at GQA 6, llama4-scout's GQA 5),
recurrentgemma-9b (head dim 256, 16 heads on one KV head, its 2,048 window)
and whisper-base (head dim 64, LoRA over 1,500 frames at d_model 512), and
the vmap engine's batched ``lora_residual_many`` over cohorts of 1 to 8
clients and its tile edges. The gradients of ``lora_residual``,
``lora_residual_many``, ``flash_attention``
and ``ssd`` (kernel forward, hand-written or recomputed backward) are held
against ``torch.autograd`` through the plain versions, and flash attention's
bf16 backward kernel also against its rounding model; the Fisher-merge and
SSD kernels against their plain versions (the Fisher kernels also over whole
adapter trees, one launch a tree, and their single-leaf wrappers against the
tree wrappers), also on the rank-heterogeneous merge's padded trees, where
the coordinates no client's Fisher covers must merge to exactly 0. LoRA runs
at ranks 16 and 32 at llava's width too (``harness.HETERO_*``).
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
LORA = (harness.LORA_SHAPES + harness.FULL_LORA_SHAPES + harness.MAMBA_LORA_SHAPES
        + harness.MOE_LORA_SHAPES + harness.NEW_FAMILY_LORA_SHAPES + harness.HETERO_LORA_SHAPES)
GROUPED = (harness.GROUPED_LORA_SHAPES + harness.FULL_GROUPED_SHAPES
           + harness.MAMBA_GROUPED_SHAPES + harness.MOE_GROUPED_SHAPES
           + harness.AUDIO_GROUPED_SHAPES)
# ... with ids uniform in [-1, n), then the grouped kernel's edges (id
# patterns, ranks, widths, an x view off 16-byte alignment)
GROUPED_CASES = ([(t, d, r, n, bt, None, 0) for t, d, r, n, bt in GROUPED]
                 + [(t, d, r, n, 0, ids, off)
                    for _, t, d, r, n, ids, off in harness.GROUPED_LORA_EDGE_SHAPES])
GROUPED_IDS = (["-".join(map(str, s)) for s in GROUPED]
               + [s[0] for s in harness.GROUPED_LORA_EDGE_SHAPES])
FLASH = (harness.FLASH_SHAPES + harness.FULL_FLASH_SHAPES + harness.DENSE_FLASH_SHAPES
         + harness.MOE_FLASH_SHAPES + harness.HYBRID_FLASH_SHAPES + harness.AUDIO_FLASH_SHAPES)
# the vmap engine's batched LoRA: small cohorts, llava's cohort rows, tile edges
MANY = (harness.MANY_LORA_SHAPES + harness.FULL_MANY_LORA_SHAPES + harness.MANY_LORA_EDGE_SHAPES
        + harness.HETERO_MANY_LORA_SHAPES)
LORA_EDGE = harness.LORA_EDGE_SHAPES
FLASH_EDGE = harness.FLASH_EDGE_SHAPES
# the bf16 tensor-core kernels against their rounding models
LORA_MODEL = LORA + LORA_EDGE + harness.FULL_LORA_GRAD_SHAPES[1:]
FLASH_MODEL = FLASH + FLASH_EDGE + harness.FULL_FLASH_GRAD_SHAPES
LORA_GRAD = (harness.LORA_GRAD_SHAPES + harness.FULL_LORA_GRAD_SHAPES
             + harness.MAMBA_LORA_GRAD_SHAPES + harness.MOE_LORA_GRAD_SHAPES
             + harness.NEW_FAMILY_LORA_GRAD_SHAPES)
FLASH_GRAD = (harness.FLASH_GRAD_SHAPES + harness.FULL_FLASH_GRAD_SHAPES
              + harness.MOE_FLASH_GRAD_SHAPES + harness.NEW_FAMILY_FLASH_GRAD_SHAPES)
FISHER = (harness.FISHER_SHAPES + harness.FISHER_EXTRA_SHAPES + harness.FULL_FISHER_SHAPES
          + harness.MAMBA_FISHER_SHAPES)
SSD = harness.SSD_SHAPES + harness.FULL_SSD_SHAPES
SSD_EDGE = harness.SSD_EDGE_SHAPES
SSD_MODEL = SSD + SSD_EDGE  # the bf16 tensor-core SSD kernel against its rounding model


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
@pytest.mark.parametrize("t,d,r,n,bt,ids,offset", GROUPED_CASES, ids=GROUPED_IDS)
def test_grouped_lora_kernel_matches_plain(cuda, t, d, r, n, bt, ids, offset, dtype):
    gen = torch.Generator(device=cuda).manual_seed(t + d + n)
    x = _randn(gen, (t, d), dtype=getattr(torch, dtype))
    down, up = _randn(gen, (n, d, r), 0.05), _randn(gen, (n, r, d), 0.05)
    if ids is None:
        idx = torch.randint(-1, n, (t,), generator=gen, device=cuda, dtype=torch.int32)
    else:
        idx = harness.grouped_ids(ids, t, n, seed=t + d + n).to(cuda)
    x = harness.offset_view(x, offset)
    got = lora_ops.grouped_lora_residual(x, down, up, idx, scale=SCALE)
    want = lora_ref.grouped_lora_residual(x, down, up, idx, scale=SCALE)
    torch.cuda.synchronize()
    harness.check_close(got, want, dtype, f"grouped t{t}d{d}n{n}")
    ident = (idx < 0) | (idx >= n)
    assert torch.equal(got[ident], x[ident])  # identity rows, bit for bit
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


def _many(gen, k, t, d, r, dtype):
    return (_randn(gen, (k, t, d), dtype=getattr(torch, dtype)), _randn(gen, (k, d, r), 0.05),
            _randn(gen, (k, r, d), 0.05))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,t,d,r", MANY)
def test_lora_many_kernel_matches_plain(cuda, k, t, d, r, dtype):
    """The batched kernel (one call over K clients) against the plain version;
    in f32 each client's rows equal the one-adapter kernel's bit for bit (a
    row's sums depend only on D and r)."""
    gen = torch.Generator(device=cuda).manual_seed(k * 1000 + t + d)
    x, down, up = _many(gen, k, t, d, r, dtype)
    before = lora_ops.lora_residual_many.launches
    got = lora_ops.lora_residual_many(x, down, up, scale=SCALE)
    assert lora_ops.lora_residual_many.launches == before + 1
    want = lora_ref.lora_residual_many(x, down, up, scale=SCALE)
    torch.cuda.synchronize()
    harness.check_close(got, want, dtype, f"lora_many k{k}t{t}d{d}r{r}")
    if dtype == "float32":
        one = torch.stack([lora_ops.lora_residual(x[i], down[i], up[i], scale=SCALE)
                           for i in range(k)])
        assert torch.equal(got, one), f"lora_many k{k}t{t}d{d}r{r}: f32 rows vs one adapter"


@pytest.mark.cuda
@pytest.mark.parametrize("k,t,d,r", MANY)
def test_lora_many_bf16_kernel_matches_its_model(cuda, k, t, d, r):
    gen = torch.Generator(device=cuda).manual_seed(k * 3 + t + d + r)
    x, down, up = _many(gen, k, t, d, r, "bfloat16")
    got = lora_ops.lora_residual_many(x, down, up, scale=SCALE)
    want = lora_ref.lora_residual_split_tf32(x, down, up, scale=SCALE)
    torch.cuda.synchronize()
    harness.check_close(got, want, "bfloat16", f"lora_many k{k}t{t}d{d}r{r} vs model",
                        harness.BF16_MODEL_TOLERANCES)
    harness.check_share(got, want, harness.LORA_MODEL_MAX_SHARE,
                        f"lora_many k{k}t{t}d{d}r{r} vs model")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,t,d,r", harness.MANY_LORA_GRAD_SHAPES)
def test_lora_many_grad_matches_plain(cuda, k, t, d, r, dtype):
    gen = torch.Generator(device=cuda).manual_seed(k * 5 + t + r)
    x, down, up = _many(gen, k, t, d, r, dtype)
    before = lora_ops.lora_residual_many.dx_launches
    got = _grads(lambda a, b, c: lora_ops.lora_residual_many(a, b, c, scale=SCALE), x, down, up)
    assert lora_ops.lora_residual_many.dx_launches == before + 1
    want = _grads(lambda a, b, c: lora_ref.lora_residual_many(a, b, c, scale=SCALE), x, down,
                  up)
    torch.cuda.synchronize()
    for name, g, w in zip(("dx", "dA", "dB"), got, want):
        harness.check_close(g, w, dtype, f"lora_many grad {name} k{k}t{t}d{d}r{r}")


@pytest.mark.cuda
def test_lora_many_rejects_mismatched_clients(cuda):
    x = torch.zeros((3, 4, 32), device=cuda)
    a, b = torch.zeros((2, 32, 4), device=cuda), torch.zeros((2, 4, 32), device=cuda)
    with pytest.raises(ValueError, match="3 clients"):
        lora_ops.lora_residual_many(x, a, b, scale=SCALE)


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
    full = shape in (harness.FULL_FLASH_GRAD_SHAPES + harness.MOE_FLASH_GRAD_SHAPES
                     + harness.NEW_FAMILY_FLASH_GRAD_SHAPES)
    tol = harness.FULL_FLASH_GRAD_TOLERANCES if full else harness.FLASH_GRAD_TOLERANCES
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        harness.check_close(g, w, dtype, f"flash grad {name} {label}", tol)


# The bf16 backward kernel: against its rounding model over every gradient
# and tile-edge shape, and through the autograd Function against autograd of
# the plain version at the shapes the grids above miss.
FLASH_BWD = FLASH_GRAD + FLASH_EDGE + harness.FLASH_BWD_SHAPES
FLASH_BWD_NEW = FLASH_EDGE + harness.FLASH_BWD_SHAPES


def _bwd_inputs(gen, shape, dtype="bfloat16"):
    """q, k, v, the kernel forward's out and lse, and an incoming gradient."""
    (q, k, v), kw = _flash_qkv(gen, shape, dtype)
    out, lse = fa_ops.flash_attention(q, k, v, return_lse=True, **kw)
    return (q, k, v, out, lse, _randn(gen, out.shape, dtype=out.dtype)), kw


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FLASH_BWD, ids=[s[0] for s in FLASH_BWD])
def test_flash_bwd_kernel_matches_its_model(cuda, shape):
    """dq, dk, dv of the bf16 kernel against ref.attention_bwd_bf16_model (P
    rounded to bf16, dS as two bf16 halves) on the same saved out and
    lse, at harness.BF16_MODEL_TOLERANCES; one backward launch, no
    forward launch; rows that see no key get exactly 0 in dq."""
    gen = torch.Generator(device=cuda).manual_seed(shape[2] * 13 + shape[3] + shape[6])
    args, kw = _bwd_inputs(gen, shape)
    before = (fa_ops.flash_attention.launches, fa_ops.flash_attention.bwd_launches)
    got = fa_ops._backward(*args, **kw)
    assert (fa_ops.flash_attention.launches, fa_ops.flash_attention.bwd_launches) == \
        (before[0], before[1] + 1)
    want = fa_ref.attention_bwd_bf16_model(*args, **kw)
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        harness.check_close(g, w, "bfloat16", f"flash bwd {name} {shape[0]} vs model",
                            harness.BF16_MODEL_TOLERANCES)
    dead = ~fa_ref.attention_mask(shape[2], shape[3], causal=kw["causal"], window=kw["window"],
                                  device=cuda).any(dim=-1)
    assert torch.equal(got[0][:, dead], torch.zeros_like(got[0][:, dead]))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FLASH_BWD_NEW, ids=[s[0] for s in FLASH_BWD_NEW])
def test_flash_bwd_kernel_grad_matches_plain(cuda, shape):
    """The autograd Function (kernel forward, kernel backward) against
    autograd through the plain version in bf16, at the flash-gradient
    tolerance, at the cells' shapes and the kernels' tile edges."""
    label, b, sq, sk, h, hkv, d, causal, window, cap, _, _ = shape
    gen = torch.Generator(device=cuda).manual_seed(sk * 19 + d)
    (q, k, v), kw = _flash_qkv(gen, shape, "bfloat16")
    before = fa_ops.flash_attention.bwd_launches
    got = _grads(lambda *a: fa_ops.flash_attention(*a, **kw), q, k, v)
    assert fa_ops.flash_attention.bwd_launches == before + 1
    want = _grads(lambda *a: fa_ref.attention(*a, **kw), q, k, v)
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        harness.check_close(g, w, "bfloat16", f"flash bwd grad {name} {label}",
                            harness.FLASH_GRAD_TOLERANCES)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [harness.FLASH_BWD_SHAPES[0], harness.FLASH_BWD_SHAPES[3],
                                   FLASH_EDGE[-1]], ids=lambda s: s[0])
def test_flash_bwd_kernel_is_deterministic(cuda, shape):
    """Two backwards on the same inputs give the same bits (no atomics: each
    gradient element is summed by one block in a fixed order)."""
    gen = torch.Generator(device=cuda).manual_seed(shape[2] + shape[6])
    args, kw = _bwd_inputs(gen, shape)
    first = fa_ops._backward(*args, **kw)
    second = fa_ops._backward(*args, **kw)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), f"{shape[0]} {name}: two calls differ"


@pytest.mark.cuda
def test_flash_bwd_dispatches_by_dtype(cuda):
    """bf16 launches the backward kernel once a backward and the forward's
    counter does not move in it; f32 on the card keeps the plain backward,
    bit for bit, and launches nothing."""
    shape = harness.FLASH_GRAD_SHAPES[1]
    for dtype in DTYPES:
        gen = torch.Generator(device=cuda).manual_seed(5)
        (q, k, v), kw = _flash_qkv(gen, shape, dtype)
        q.requires_grad_(True)
        out = fa_ops.flash_attention(q, k, v, **kw)
        g = torch.ones_like(out)
        before = (fa_ops.flash_attention.launches, fa_ops.flash_attention.bwd_launches)
        out.backward(g)
        after = (fa_ops.flash_attention.launches, fa_ops.flash_attention.bwd_launches)
        assert after == (before[0], before[1] + (dtype == "bfloat16")), dtype
        if dtype == "float32":
            _, lse = fa_ops.flash_attention(q.detach(), k, v, return_lse=True, **kw)
            want = fa_ref.attention_bwd(q.detach(), k, v, out.detach(), lse, g, **kw)[0]
            assert torch.equal(q.grad, want)


@pytest.mark.cuda
def test_flash_bwd_takes_a_non_contiguous_gradient(cuda):
    """An incoming gradient that is a strided view (as autograd may hand one
    in) gives the bits of its contiguous copy."""
    shape = FLASH_EDGE[3]
    gen = torch.Generator(device=cuda).manual_seed(11)
    (q, k, v, out, lse, g), kw = _bwd_inputs(gen, shape)
    g_view = g.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
    assert not g_view.is_contiguous() and torch.equal(g_view, g)
    got = fa_ops._backward(q, k, v, out, lse, g_view, **kw)
    want = fa_ops._backward(q, k, v, out, lse, g, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,n,bn", FISHER)
def test_fisher_kernels_match_plain(cuda, k, n, bn, dtype):
    gen = torch.Generator(device=cuda).manual_seed(k * 1000 + n)
    dt = getattr(torch, dtype)
    theta = _randn(gen, (k, n), dtype=dt)
    fisher = (torch.rand((k, n), generator=gen, device=cuda) + 0.01).to(dt)
    w = (torch.rand((k,), generator=gen, device=cuda) + 0.1).cpu()  # host weights
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


FISHER_TREES = (harness.FISHER_TREES + harness.FULL_FISHER_TREES + harness.MAMBA_FISHER_TREES
                + harness.FISHER_TREE_EDGES)
FISHER_TREE_IDS = [f"k{k}-" + ("x".join(map(str, n)) if len(n) < 5 else f"{len(n)}leaves")
                   for k, n in FISHER_TREES]
MAX_LEAVES = 32  # csrc/fisher_merge.cu::kMaxLeaves: leaves one launch holds


def _fisher_tree(gen, k, sizes, dtype, offset):
    """K clients' leaf lists (θ, F) on the card and K host weights. With
    ``offset``, every odd leaf is a view one element into its buffer, off
    16-byte alignment, so the kernel's scalar path takes it."""
    def leaf(n, i, positive):
        off = offset * (i % 2)
        t = (torch.rand((n + off,), generator=gen, device=gen.device) + 0.01 if positive
             else torch.randn((n + off,), generator=gen, device=gen.device))
        return t.to(dtype)[off:]

    thetas = [[leaf(n, i, False) for i, n in enumerate(sizes)] for _ in range(k)]
    fishers = [[leaf(n, i, True) for i, n in enumerate(sizes)] for _ in range(k)]
    return thetas, fishers, (torch.rand((k,), generator=gen, device=gen.device) + 0.1).cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("offset", (0, 1))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,sizes", FISHER_TREES, ids=FISHER_TREE_IDS)
def test_fisher_tree_kernels_match_plain(cuda, k, sizes, dtype, offset):
    """One merge launch a tree (more only past the launch's pointer or leaf
    cap), one fold launch an upload; f32 bit for bit against the plain
    versions (which sum in the kernels' order), bf16 at the harness tolerance."""
    gen = torch.Generator(device=cuda).manual_seed(k * 31 + len(sizes) + offset)
    dt = getattr(torch, dtype)
    thetas, fishers, w = _fisher_tree(gen, k, sizes, dt, offset)
    per_launch = min(MAX_LEAVES, fm_ops.max_clients() // k)
    before = fm_ops.fisher_merge.launches
    got = fm_ops.fisher_merge_leaves(thetas, fishers, w)
    assert fm_ops.fisher_merge.launches - before == -(-len(sizes) // per_launch)
    want = fm_ref.fisher_merge_leaves(thetas, fishers, w)
    torch.cuda.synchronize()
    for leaf, (g, p) in enumerate(zip(got, want)):
        if dtype == "float32":
            assert torch.equal(g, p), f"merge leaf {leaf}"
        else:
            harness.check_close(g, p, dtype, f"merge k{k} leaf {leaf}")
    nums = [torch.zeros(n, device=cuda) for n in sizes]
    dens = [torch.zeros(n, device=cuda) for n in sizes]
    pnums, pdens = [t.clone() for t in nums], [t.clone() for t in dens]
    before = fm_ops.fisher_fold.launches
    for i in range(min(k, 8)):
        fm_ops.fisher_fold_leaves(nums, dens, thetas[i], fishers[i], float(w[i]))
        fm_ref.fisher_fold_leaves(pnums, pdens, thetas[i], fishers[i], float(w[i]))
    assert fm_ops.fisher_fold.launches - before == min(k, 8) * -(-len(sizes) // MAX_LEAVES)
    torch.cuda.synchronize()
    for a, b in zip(nums + dens, pnums + pdens):
        assert torch.equal(a, b), "fold"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_fisher_merge_on_padded_rank_blocks(cuda, dtype):
    """The hetero merge's trees: clients at ranks 16 and 32 padded to 64
    (``down`` (4096, 64), ``up`` (64, 4096)), each Fisher zero on its padding.
    One launch; f32 bit for bit against the plain version, bf16 at the
    harness tolerance; past rank 32 no client has mass: exactly 0, no NaN."""
    ranks, rmax, d = harness.HETERO_FISHER_PAD
    gen = torch.Generator(device=cuda).manual_seed(24)
    dt = getattr(torch, dtype)
    pad = lambda down, up: [torch.nn.functional.pad(down, (0, rmax - down.shape[1])),
                            torch.nn.functional.pad(up, (0, 0, 0, rmax - up.shape[0]))]
    thetas, fishers = [], []
    for r in ranks:
        thetas.append([t.to(dt) for t in pad(_randn(gen, (d, r)), _randn(gen, (r, d)))])
        fishers.append([(t.abs() + 0.01).to(dt)
                        for t in pad(_randn(gen, (d, r)), _randn(gen, (r, d)))])
    w = torch.tensor([3.0, 1.0])
    before = fm_ops.fisher_merge.launches
    got = fm_ops.fisher_merge_leaves(thetas, fishers, w)
    assert fm_ops.fisher_merge.launches - before == 1
    want = fm_ref.fisher_merge_leaves(thetas, fishers, w)
    torch.cuda.synchronize()
    for leaf, (g, p) in enumerate(zip(got, want)):
        if dtype == "float32":
            assert torch.equal(g, p), f"leaf {leaf}"
        else:
            harness.check_close(g, p, dtype, f"padded merge leaf {leaf}")
        assert not torch.isnan(g).any()
    r_hi = max(ranks)
    assert not got[0][:, r_hi:].any() and not got[1][r_hi:].any()
    assert got[0][:, :r_hi].any() and got[1][:r_hi].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,n,bn", harness.FISHER_SHAPES + harness.FULL_FISHER_SHAPES)
def test_fisher_single_leaf_wrappers_match_tree(cuda, k, n, bn, dtype):
    """fisher_merge / fisher_fold on a (K, N) stack are the tree kernel at
    L = 1: bit-identical to the tree wrappers given the stack's rows."""
    gen = torch.Generator(device=cuda).manual_seed(k + n)
    dt = getattr(torch, dtype)
    theta = _randn(gen, (k, n), dtype=dt)
    fisher = (torch.rand((k, n), generator=gen, device=cuda) + 0.01).to(dt)
    w = [0.1 + 0.2 * i for i in range(k)]
    tree = fm_ops.fisher_merge_leaves([[t] for t in theta], [[f] for f in fisher], w)[0]
    assert torch.equal(fm_ops.fisher_merge(theta, fisher, w), tree)
    num, den = torch.zeros(n, device=cuda), torch.zeros(n, device=cuda)
    tnum, tden = [num.clone()], [den.clone()]
    for i in range(k):
        fm_ops.fisher_fold(num, den, theta[i], fisher[i], w[i])
        fm_ops.fisher_fold_leaves(tnum, tden, [theta[i]], [fisher[i]], w[i])
    torch.cuda.synchronize()
    assert torch.equal(num, tnum[0]) and torch.equal(den, tden[0])


@pytest.mark.cuda
def test_fisher_cuda_weights_raise(cuda):
    """Weights on the card would cost a sync to read and break graph capture."""
    theta = torch.ones((2, 8), device=cuda)
    w = torch.full((2,), 0.5, device=cuda)
    with pytest.raises(ValueError, match="would wait on the card"):
        fm_ops.fisher_merge(theta, theta, w)
    with pytest.raises(ValueError, match="would wait on the card"):
        fm_ops.fisher_merge_leaves([[theta[0]], [theta[1]]], [[theta[0]], [theta[1]]], w)
    with pytest.raises(ValueError, match="at most"):
        k = fm_ops.max_clients() + 1
        fm_ops.fisher_merge(torch.ones((k, 4), device=cuda), torch.ones((k, 4), device=cuda),
                            [1.0] * k)


_ssd_tol = harness.ssd_tolerances


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
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,h,p,n,q", SSD_EDGE)
def test_ssd_kernel_edges_match_plain(cuda, b, s, h, p, n, q, dtype):
    """More chunks than the main shapes (the carried state passed over three),
    batch 3, S = 1, P and N off the tensor-core tiles, S below the chunk
    (Q off 16 and 64), and a one-tile chunk with a two-step last chunk."""
    gen = torch.Generator(device=cuda).manual_seed(s * 11 + p + n)
    args = _ssd_inputs(gen, b, s, h, p, n, getattr(torch, dtype))
    before = ssd_ops.ssd.launches
    got = ssd_ops.ssd(*args, chunk=q)
    want = ssd_ref.ssd_chunked(*args, chunk=q)
    torch.cuda.synchronize()
    assert ssd_ops.ssd.launches == before + 1
    harness.check_close(got, want, dtype, f"ssd edge b{b}s{s}h{h}p{p}n{n}q{q}",
                        _ssd_tol(b, s, h, p, n, q))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,n,q", SSD_MODEL)
def test_ssd_bf16_kernel_matches_its_model(cuda, b, s, h, p, n, q):
    """The bf16 tensor-core kernel against ref.ssd_chunked_bf16_model (w·B,
    the scaled score tile and the carried state rounded to bf16) at
    harness.BF16_MODEL_TOLERANCES, with at most harness.SSD_MODEL_MAX_SHARE
    of the elements differing."""
    gen = torch.Generator(device=cuda).manual_seed(s * 5 + h + n)
    args = _ssd_inputs(gen, b, s, h, p, n, torch.bfloat16)
    got = ssd_ops.ssd(*args, chunk=q)
    want = ssd_ref.ssd_chunked_bf16_model(*args, chunk=q)
    torch.cuda.synchronize()
    what = f"ssd b{b}s{s}h{h}p{p}n{n}q{q} vs model"
    harness.check_close(got, want, "bfloat16", what, harness.BF16_MODEL_TOLERANCES)
    harness.check_share(got, want, harness.SSD_MODEL_MAX_SHARE, what)


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
