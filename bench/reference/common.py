"""Precision of the references: IEEE float32 with TF32 off, or TF32 (the
control: the step below float32 that a later change could be tempted by).

TF32 is computed by rounding each product's operands to TF32's 10-bit
mantissa (round to nearest, ties away) and accumulating in float32, which
is what the card's TF32 tensor cores do.  Rounding explicitly gives the
same arithmetic on the CPU, where PyTorch has no TF32."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def ieee_fp32():
    """Inside the block every product is an IEEE float32 GEMM: TF32 off,
    and cuDNN off, so that a convolution is PyTorch's own im2col and
    cuBLAS GEMM (cuDNN's FFT and Winograd algorithms are not float32-exact).
    Restored after."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


class _RoundOperand(torch.autograd.Function):
    """A product's operand rounded to TF32; the gradient passes as it is."""

    @staticmethod
    def forward(ctx, x):
        return to_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundGradient(torch.autograd.Function):
    """The identity, whose incoming gradient is rounded to TF32: it is the
    operand of the backward's products."""

    @staticmethod
    def forward(ctx, y):
        return y

    @staticmethod
    def backward(ctx, g):
        return to_tf32(g)


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def product(fn, x: torch.Tensor, w: torch.Tensor, tf32: bool, **kw):
    """``fn(x, w, **kw)`` (a convolution or a matrix product) at the
    reference's precision: in TF32 both operands, and the gradient that
    reaches the output, are rounded to TF32."""
    if not tf32:
        return fn(x, w, **kw)
    y = fn(_RoundOperand.apply(x), _RoundOperand.apply(w), **kw)
    return _RoundGradient.apply(y)
