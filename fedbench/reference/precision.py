"""The precisions of the plain reference: float32 throughout, or the
control's fp8 (e4m3, one scale a tensor) wherever the program keeps bf16.
Every family's reference computes through a ``Prec``."""
from __future__ import annotations

import torch


def to_fp8(t):
    """t rounded to fp8 e4m3 under one scale that maps its largest entry to
    448, the format's largest, and back to f32."""
    scale = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _FP8MatMul(torch.autograd.Function):
    """a @ b with both operands and the product rounded to fp8; the
    backward's two products round theirs the same way."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = to_fp8(a), to_fp8(b)
        ctx.save_for_backward(qa, qb)
        ctx.shapes = (a.shape, b.shape)
        return to_fp8(torch.matmul(qa, qb))

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = to_fp8(g)
        ga = to_fp8(torch.matmul(qg, qb.transpose(-1, -2))).sum_to_size(ctx.shapes[0])
        gb = to_fp8(torch.matmul(qa.transpose(-1, -2), qg)).sum_to_size(ctx.shapes[1])
        return ga, gb


class _FP8Store(torch.autograd.Function):
    """An activation kept in fp8, and its gradient too."""

    @staticmethod
    def forward(ctx, x):
        return to_fp8(x)

    @staticmethod
    def backward(ctx, g):
        return to_fp8(g)


class Prec:
    """Float32 throughout, or the control: fp8 wherever the program keeps
    bf16, the operands and results of every matrix product and the residual
    stream between them (and, in the backward, their gradients)."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def mm(self, a, b):
        return _FP8MatMul.apply(a, b) if self.fp8 else torch.matmul(a, b)

    def store(self, x):
        return _FP8Store.apply(x) if self.fp8 else x


F32 = Prec()


def f32(t):
    return t.to(torch.float32)


def upcast(tree):
    """A copy of a layer's weights in f32."""
    if isinstance(tree, dict):
        return {k: upcast(v) for k, v in tree.items()}
    return f32(tree)
