"""Public wrapper of the SSD chunked-scan kernel (``repro.kernels.ssd_scan.ops``).

A tensor on the CPU takes the plain version ``ref.ssd_chunked``. A tensor on
a CUDA device launches the hand-written kernel of ``csrc/ssd_scan.cu`` or
raises. ``ssd.launches`` counts the calls that launch the kernel, one per
call, whatever the number of device launches it makes (up to three, one a
phase: ``csrc/ssd_scan.cu``).

``ssd`` is differentiable in (x, dt, A, B, C) through ``SSDScan``: the
forward is the kernel; the backward recomputes ``ref.ssd_chunked`` on the
saved inputs under autograd and returns its gradients. The JAX package has
no backward for its Pallas kernel (``pallas_call`` has no transpose rule and
``ssd`` no custom VJP), so its training path differentiates the jnp oracle
``ref.ssd_chunked``; this backward is that oracle's gradient. It holds the
(Bt, chunks, H, Q, Q) f32 decay tensors of one layer at a time. A backward
kernel is ROADMAP performance work.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan import ref

MAX_N = 128  # csrc/ssd_scan.cu::kMaxN
MAX_P = 64   # csrc/ssd_scan.cu::kMaxP


def ssd(x, dt, A, B, C, *, chunk: int):
    """Mamba2 SSD: y_t = C_t · h_t with h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_tᵀ.

    x (Bt, S, H, P); dt (Bt, S, H) in x's dtype; A (H,) f32; B, C (Bt, S, N)
    in x's dtype. Returns y like x. ``chunk`` is the config's chunk_size: it
    sets the f32 summation order.
    """
    return SSDScan.apply(x, dt, A, B, C, int(chunk))


ssd.launches = 0


class SSDScan(torch.autograd.Function):
    """Forward through the kernel (or its plain version), backward by autograd
    through the plain version recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        return _forward(x, dt, A, B, C, chunk)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        wanted = [i for i, need in enumerate(ctx.needs_input_grad[:5]) if need]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(i in wanted) for i, t in enumerate(saved)]
            y = ref.ssd_chunked(*leaves, chunk=ctx.chunk)
            grads = torch.autograd.grad(y, [leaves[i] for i in wanted], g)
        out = [None] * 6
        for i, gr in zip(wanted, grads):
            out[i] = gr
        return tuple(out)


def _rows(t, inner: int):
    """``t`` itself when its last ``inner`` axes are contiguous (the kernel
    takes batch and time strides), else a contiguous copy."""
    expect = 1
    for axis in range(t.dim() - 1, t.dim() - 1 - inner, -1):
        if t.shape[axis] != 1 and t.stride(axis) != expect:
            return t.contiguous()
        expect *= t.shape[axis]
    return t


def _forward(x, dt, A, B, C, chunk: int):
    """The plain version on the CPU, the kernel on a CUDA device."""
    if x.device.type == "cpu":
        return ref.ssd_chunked(x, dt, A, B, C, chunk=chunk)
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    if dt.shape != (Bt, S, H) or A.shape != (H,) or B.shape != (Bt, S, N) or C.shape != B.shape:
        raise ValueError(f"ssd: x {tuple(x.shape)} dt {tuple(dt.shape)} A {tuple(A.shape)} "
                         f"B {tuple(B.shape)} C {tuple(C.shape)} do not fit")
    if x.dtype not in build.DTYPE_CODES or {dt.dtype, B.dtype, C.dtype} != {x.dtype}:
        raise ValueError(f"ssd: x, dt, B, C must share one dtype of {list(build.DTYPE_CODES)}, "
                         f"got {x.dtype}/{dt.dtype}/{B.dtype}/{C.dtype}")
    if A.dtype != torch.float32:
        raise ValueError(f"ssd: A must be float32, got {A.dtype}")
    if not (1 <= N <= MAX_N and 1 <= P <= MAX_P) or chunk < 1:
        raise ValueError(f"ssd: N {N} (max {MAX_N}), P {P} (max {MAX_P}), chunk {chunk}")
    x, B, C = _rows(x, 2), _rows(B, 1), _rows(C, 1)
    dt, A = dt.contiguous(), A.contiguous()
    for t in (x, dt, A, B, C):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"ssd: tensors must share one CUDA device, got {t.device}")
    out = torch.empty((Bt, S, H, P), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = build.library().repro_ssd_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            out.data_ptr(), Bt, S, H, P, N, min(chunk, max(S, 1)), x.stride(0), x.stride(1),
            B.stride(0), B.stride(1), C.stride(0), C.stride(1), build.DTYPE_CODES[x.dtype],
            build.stream_of(x))
    build.check(err, "ssd")
    ssd.launches += 1
    return out
