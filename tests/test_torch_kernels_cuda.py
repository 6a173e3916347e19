"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without an NVIDIA card every test skips. The file imports
neither JAX nor the JAX package, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: ``tests/conftest.py`` configures JAX.) Grids and
tolerances are ``repro_torch.kernels.harness``, the port's copy of the JAX
package's ``tests/kernel_harness.py``, plus the full-width llava-1.5-7b shapes.
"""
import pytest
import torch

from repro_torch.kernels import harness
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.lora import ops as lora_ops
from repro_torch.kernels.lora import ref as lora_ref

DTYPES = ("float32", "bfloat16")
SCALE = 2.0
LORA = harness.LORA_SHAPES + harness.FULL_LORA_SHAPES
GROUPED = harness.GROUPED_LORA_SHAPES + harness.FULL_GROUPED_SHAPES
FLASH = harness.FLASH_SHAPES + harness.FULL_FLASH_SHAPES


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
