"""Public wrappers of the LoRA kernels (``repro.kernels.lora.ops``).

A tensor on the CPU takes the plain version in ``ref.py``. A tensor on a CUDA
device launches the hand-written kernel of ``csrc/lora.cu`` or raises.
Each wrapper counts its kernel launches in ``<wrapper>.launches`` (one per
kernel call, whatever number of CUDA launches the call makes: two or three
for the bf16 single-adapter kernel, two per 256 rows for the grouped kernel
and for f32 x). The grouped kernel reads the adapter ids on the device only,
so a call never waits for the card and a CUDA graph can capture it.

``lora_residual`` is differentiable in (x, down, up): ``LoraResidual`` ports
the JAX package's custom VJP (``repro/kernels/lora/ops.py::_lora_2d_bwd``).
For y = x + s·(x·A)·B,

    dx = g + s·(g·Bᵀ)·Aᵀ   the forward kernel on (g, Bᵀ, Aᵀ), only when x needs it
    dA = s · xᵀ·(g·Bᵀ)     f32 products (adapter-sized: torch.matmul, as the
    dB = s · (x·A)ᵀ·g      JAX package leaves them to XLA)

FedNano's x (token embeddings, connector output) is frozen, so on its path
the backward launches no kernel. Under FedDPA-F the shared adapters' output
is the personal adapter's x, so their gradient takes the dx launch
(``lora_residual.dx_launches`` counts those among ``launches``).

``lora_residual_many`` is the cohort engine's: K clients' rows x (K, T, D),
each through its own adapter (K, D, r) / (K, r, D), in one kernel call (what
``jax.vmap`` makes of the Pallas call). ``LoraResidualMany`` is the same VJP
per client: dx the batched kernel on the transposed stacks (counted in
``lora_residual_many.dx_launches``), dA and dB each client's f32 products,
as ``LoraResidual`` takes them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.lora import ref

MAX_RANK = 256  # csrc/lora.cu::kMaxRank
SPLIT = 16      # csrc/lora.cu::kSplit: d-chunks of the down-projection pass


def _check_x(what, x):
    if x.dtype not in build.DTYPE_CODES:
        raise ValueError(f"{what}: x dtype {x.dtype} not in {list(build.DTYPE_CODES)}")


def _check_adapters(what, down, up, d):
    if down.dtype != torch.float32 or up.dtype != torch.float32:
        raise ValueError(f"{what}: adapters must be float32, got {down.dtype}/{up.dtype}")
    r = down.shape[-1]
    if down.shape[-2:] != (d, r) or up.shape[-2:] != (r, d):
        raise ValueError(f"{what}: adapter shapes {tuple(down.shape)}/{tuple(up.shape)} "
                         f"do not fit width {d}")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"{what}: rank {r} outside [1, {MAX_RANK}]")
    return r


def _scratch(x, r):
    """fp32 partial sums of x·A, (rows, SPLIT, r), between a kernel's passes."""
    return torch.empty((x.numel() // x.shape[-1]) * SPLIT * r, dtype=torch.float32,
                       device=x.device)


def lora_residual(x, down, up, *, scale: float):
    """y = x + scale·(x·down)·up for x (..., D); down (D, r); up (r, D) in f32.

    Differentiable in (x, down, up); gradients come back in the input dtypes.
    """
    d = x.shape[-1]
    y = LoraResidual.apply(x.reshape(-1, d), down, up, float(scale))
    return y.reshape(x.shape)


lora_residual.launches = 0
lora_residual.dx_launches = 0  # of those, the backward's dx (FedDPA-F's shared adapters)


class LoraResidual(torch.autograd.Function):
    """y = x + s·(x·A)·B on x (T, D), with the JAX package's hand-written VJP."""

    @staticmethod
    def forward(ctx, x, down, up, scale):
        ctx.save_for_backward(x, down, up)
        ctx.scale = scale
        return _residual(x, down, up, scale)

    @staticmethod
    def backward(ctx, g):
        x, down, up = ctx.saved_tensors
        s = ctx.scale
        dx = d_down = d_up = None
        if ctx.needs_input_grad[0]:  # the kernel reads raw pointers: contiguous copies
            dx = _residual(g.contiguous(), up.t().contiguous(), down.t().contiguous(), s,
                           dx=True).to(x.dtype)
        gf, xf = g.float(), x.float()
        if ctx.needs_input_grad[1]:
            d_down = (s * (xf.t() @ (gf @ up.float().t()))).to(down.dtype)   # (D, r)
        if ctx.needs_input_grad[2]:
            d_up = (s * ((xf @ down.float()).t() @ gf)).to(up.dtype)         # (r, D)
        return dx, d_down, d_up, None


def _residual(x, down, up, scale: float, dx: bool = False):
    """x (T, D): the plain version on the CPU, the kernel on a CUDA device.
    ``dx``: the call is the backward's input gradient (counted apart as well)."""
    if x.device.type == "cpu":
        return ref.lora_residual(x, down, up, scale=scale)
    d = x.shape[-1]
    build.require_cuda("lora_residual", x, down, up)
    _check_x("lora_residual", x)
    r = _check_adapters("lora_residual", down, up, d)
    if down.dim() != 2:
        raise ValueError("lora_residual: down must be (D, r)")
    out, scratch = torch.empty_like(x), _scratch(x, r)
    with torch.cuda.device(x.device):
        err = build.library().repro_lora_residual(
            x.data_ptr(), down.data_ptr(), up.data_ptr(), scratch.data_ptr(), scratch.numel(),
            out.data_ptr(), x.numel() // d, d, r, float(scale), build.DTYPE_CODES[x.dtype],
            build.stream_of(x))
    build.check(err, "lora_residual")
    lora_residual.launches += 1
    lora_residual.dx_launches += dx
    return out


def lora_residual_many(x, down, up, *, scale: float):
    """y_k = x_k + scale·(x_k·down_k)·up_k for x (K, T, D); down (K, D, r);
    up (K, r, D) in f32: one kernel call over the K clients.

    Differentiable in (x, down, up); gradients come back in the input dtypes.
    """
    return LoraResidualMany.apply(x, down, up, float(scale))


lora_residual_many.launches = 0
lora_residual_many.dx_launches = 0


class LoraResidualMany(torch.autograd.Function):
    """``LoraResidual`` for K clients at once, each with its own adapter."""

    @staticmethod
    def forward(ctx, x, down, up, scale):
        ctx.save_for_backward(x, down, up)
        ctx.scale = scale
        return _residual_many(x, down, up, scale)

    @staticmethod
    def backward(ctx, g):
        x, down, up = ctx.saved_tensors
        s = ctx.scale
        dx = d_down = d_up = None
        if ctx.needs_input_grad[0]:
            dx = _residual_many(g.contiguous(), up.transpose(1, 2).contiguous(),
                                down.transpose(1, 2).contiguous(), s, dx=True).to(x.dtype)
        # client by client: a batched product is less accurate on the card (ref.py)
        gf, xf = g.float(), x.float()
        k = range(x.shape[0])
        if ctx.needs_input_grad[1]:
            d_down = torch.stack([s * (xf[i].t() @ (gf[i] @ up[i].float().t()))
                                  for i in k]).to(down.dtype)                   # (K, D, r)
        if ctx.needs_input_grad[2]:
            d_up = torch.stack([s * ((xf[i] @ down[i].float()).t() @ gf[i])
                                for i in k]).to(up.dtype)                       # (K, r, D)
        return dx, d_down, d_up, None


MAX_CLIENTS = 65535      # csrc/lora.cu: the clients of one call (a grid dimension)
MAX_TILE_ROWS = 524280   # csrc/lora.cu: f32 rows a client (65,535 tiles of 8)


def _residual_many(x, down, up, scale: float, dx: bool = False):
    """x (K, T, D): the plain version on the CPU, the kernel on a CUDA device."""
    if x.device.type == "cpu":
        return ref.lora_residual_many(x, down, up, scale=scale)
    build.require_cuda("lora_residual_many", x, down, up)
    _check_x("lora_residual_many", x)
    if x.dim() != 3 or down.dim() != 3 or up.dim() != 3:
        raise ValueError("lora_residual_many: x (K, T, D), down (K, D, r), up (K, r, D)")
    k, t, d = x.shape
    r = _check_adapters("lora_residual_many", down, up, d)
    if down.shape[0] != k or up.shape[0] != k:
        raise ValueError(f"lora_residual_many: {k} clients' rows, adapters for "
                         f"{down.shape[0]}/{up.shape[0]}")
    if not 1 <= k <= MAX_CLIENTS or (x.dtype == torch.float32 and t > MAX_TILE_ROWS):
        raise ValueError(f"lora_residual_many: K = {k}, T = {t} outside the kernel's grid")
    out, scratch = torch.empty_like(x), _scratch(x, r)
    with torch.cuda.device(x.device):
        err = build.library().repro_lora_residual_many(
            x.data_ptr(), down.data_ptr(), up.data_ptr(), scratch.data_ptr(), scratch.numel(),
            out.data_ptr(), k, t, d, r, float(scale), build.DTYPE_CODES[x.dtype],
            build.stream_of(x))
    build.check(err, "lora_residual_many")
    lora_residual_many.launches += 1
    lora_residual_many.dx_launches += dx
    return out


def grouped_lora_residual(x, down, up, idx, *, scale: float):
    """Multi-tenant LoRA: per-row adapter ids into a stacked f32 bank.

    x (..., D); down (N, D, r); up (N, r, D); idx (...) int32 aligned with
    x's leading shape. Ids outside [0, N) leave the row exactly as x.
    """
    if x.device.type == "cpu":
        return ref.grouped_lora_residual(x, down, up, idx, scale=scale)
    d = x.shape[-1]
    build.require_cuda("grouped_lora_residual", x, down, up, idx)
    _check_x("grouped_lora_residual", x)
    r = _check_adapters("grouped_lora_residual", down, up, d)
    if down.dim() != 3 or up.shape[0] != down.shape[0]:
        raise ValueError("grouped_lora_residual: banks must be (N, D, r) and (N, r, D)")
    if idx.dtype != torch.int32 or idx.shape != x.shape[:-1]:
        raise ValueError("grouped_lora_residual: idx must be int32 of x's leading shape")
    out, scratch = torch.empty_like(x), _scratch(x, r)
    with torch.cuda.device(x.device):
        err = build.library().repro_grouped_lora_residual(
            x.data_ptr(), down.data_ptr(), up.data_ptr(), idx.data_ptr(), scratch.data_ptr(),
            scratch.numel(), out.data_ptr(), x.numel() // d, d, r, down.shape[0], float(scale),
            build.DTYPE_CODES[x.dtype], build.stream_of(x))
    build.check(err, "grouped_lora_residual")
    grouped_lora_residual.launches += 1
    return out


grouped_lora_residual.launches = 0
