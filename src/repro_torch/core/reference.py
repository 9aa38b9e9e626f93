"""Reference engines and the f64 oracle harness, on PyTorch.

Counterpart of ``repro.core.reference`` (the DarkNet-style zero-insert +
im2col engines, the lhs-dilated, rhs-dilated and strided oracles) plus the
float64 oracle and its
ULP-scaled error bound from the JAX suite's ``tests/conftest.py``, so the
card can check the kernel with nothing of JAX present.

Every float32 reference here runs with TF32 off (``ieee_fp32``): cuDNN
convolutions default to TF32 on Hopper, which keeps about three decimal
digits and would void ``ulp_bound``'s IEEE-f32 product assumption.
"""
from __future__ import annotations

import contextlib
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.untangle import pad_or_crop

Pair = tuple[int, int]


@contextlib.contextmanager
def ieee_fp32():
    """Turn TF32 off for cuBLAS and cuDNN inside the block (restored after)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def zero_insert(x: torch.Tensor, strides: Pair) -> torch.Tensor:
    """Materialize the s-dilated input x_hat (the thing HUGE2 never builds)."""
    sh, sw = strides
    if sh == 1 and sw == 1:
        return x
    *b, h, w, c = x.shape
    out = x.new_zeros((*b, (h - 1) * sh + 1, (w - 1) * sw + 1, c))
    out[..., ::sh, ::sw, :] = x
    return out


def dilate_kernel(kernel: torch.Tensor, dilation: Pair) -> torch.Tensor:
    """Materialize the zero-inserted (atrous) kernel."""
    dh, dw = dilation
    if dh == 1 and dw == 1:
        return kernel
    r, s, c, n = kernel.shape
    out = kernel.new_zeros(((r - 1) * dh + 1, (s - 1) * dw + 1, c, n))
    out[::dh, ::dw] = kernel
    return out


def im2col(x: torch.Tensor, rs: Pair, strides: Pair = (1, 1)) -> torch.Tensor:
    """Explicit im2col: (B,H,W,C) -> (B, OH, OW, R*S*C) patch buffer."""
    r, s = rs
    sh, sw = strides
    h, w = x.shape[-3], x.shape[-2]
    oh = (h - r) // sh + 1
    ow = (w - s) // sw + 1
    cols = [x[..., m:m + (oh - 1) * sh + 1:sh, n:n + (ow - 1) * sw + 1:sw, :]
            for m in range(r) for n in range(s)]
    return torch.cat(cols, dim=-1)


def im2col_conv(x: torch.Tensor, kernel: torch.Tensor, *,
                strides: Pair = (1, 1),
                padding: Sequence[Pair] = ((0, 0), (0, 0))) -> torch.Tensor:
    """Standard conv through the explicit im2col buffer + one GEMM."""
    r, s, c, n = kernel.shape
    buf = im2col(pad_or_crop(x, padding), (r, s), strides)   # materialized!
    with ieee_fp32():
        return torch.matmul(buf, kernel.reshape(r * s * c, n))


def naive_conv_transpose2d(x: torch.Tensor, kernel: torch.Tensor, *,
                           strides: Pair,
                           padding: Sequence[Pair]) -> torch.Tensor:
    """DarkNet path: zero-insert the input, then im2col GEMM at stride 1."""
    return im2col_conv(zero_insert(x, strides), kernel, strides=(1, 1),
                       padding=padding)


def oracle_conv_transpose2d(x: torch.Tensor, kernel: torch.Tensor, *,
                            strides: Pair,
                            padding: Sequence[Pair]) -> torch.Tensor:
    """The lhs-dilated correlation (``lax.conv_general_dilated`` with
    ``lhs_dilation=strides``) through PyTorch's own stride-1 ``conv2d``:
    NHWC ``x``, HWIO ``kernel``, NHWC out."""
    xd = pad_or_crop(zero_insert(x, strides), padding)
    with ieee_fp32():
        y = F.conv2d(xd.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1)


def naive_dilated_conv2d(x: torch.Tensor, kernel: torch.Tensor, *,
                         dilation: Pair, strides: Pair = (1, 1),
                         padding: Sequence[Pair] = ((0, 0), (0, 0))
                         ) -> torch.Tensor:
    """DarkNet path: materialize the dilated kernel, then im2col GEMM."""
    return im2col_conv(x, dilate_kernel(kernel, dilation), strides=strides,
                       padding=padding)


def oracle_dilated_conv2d(x: torch.Tensor, kernel: torch.Tensor, *,
                          dilation: Pair, strides: Pair = (1, 1),
                          padding: Sequence[Pair] = ((0, 0), (0, 0))
                          ) -> torch.Tensor:
    """The rhs-dilated strided correlation (``lax.conv_general_dilated``
    with ``window_strides``/``rhs_dilation``) through PyTorch's ``conv2d``
    on the padded (or cropped) plane: NHWC ``x``, HWIO ``kernel``, NHWC
    out."""
    xp = pad_or_crop(x, padding)
    with ieee_fp32():
        y = F.conv2d(xp.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1),
                     stride=tuple(strides), dilation=tuple(dilation))
    return y.permute(0, 2, 3, 1)


def oracle_conv2d(x: torch.Tensor, kernel: torch.Tensor, *,
                  strides: Pair = (1, 1),
                  padding: Sequence[Pair] = ((0, 0), (0, 0))) -> torch.Tensor:
    """The single-kind ('conv') oracle: the strided correlation."""
    return oracle_dilated_conv2d(x, kernel, dilation=(1, 1), strides=strides,
                                 padding=padding)


def conv_oracle_f64(x, k, *, strides=(1, 1), dilation=(1, 1),
                    padding=((0, 0), (0, 0))):
    """Float64 correlation oracle: ``(y64, amax64)`` where ``y64`` is the
    output computed in float64 and ``amax64`` the same contraction over
    ``|x|·|k|`` (the condition companion of ``ulp_bound``).  Runs on the
    device of ``x`` (numpy inputs run on the CPU)."""
    x64 = torch.as_tensor(x).to(torch.float64)
    k64 = torch.as_tensor(k).to(device=x64.device, dtype=torch.float64)
    (sh, sw), (dh, dw) = strides, dilation
    r, s, c, n = k64.shape
    x64 = pad_or_crop(x64, padding)
    b, hp, wp, _ = x64.shape
    oh = (hp - (r - 1) * dh - 1) // sh + 1
    ow = (wp - (s - 1) * dw - 1) // sw + 1
    y = x64.new_zeros((b, oh, ow, n))
    amax = x64.new_zeros((b, oh, ow, n))
    for m in range(r):
        for nn in range(s):
            xs = x64[:, m * dh:m * dh + (oh - 1) * sh + 1:sh,
                     nn * dw:nn * dw + (ow - 1) * sw + 1:sw, :]
            y += xs @ k64[m, nn]
            amax += xs.abs() @ k64[m, nn].abs()
    return y, amax


def ulp_bound(y64, amax64, n_terms, out_dtype=torch.float32):
    """Elementwise absolute error bound for an f32-accumulated contraction of
    ``n_terms`` products, against the float64 oracle (Higham §4.2).

    For any summation order of n f32 terms, ``|fl(Σ) - Σ| ≤ γ_n·Σ|t_i|``
    with ``γ_n = n·u/(1 - n·u)`` and ``u = 2^-24``; one more rounding per
    product is absorbed by ``n+1``.  A final cast to ``out_dtype`` adds half
    an output ULP, ``ε_out·|y|``.  ``n_terms`` may be a tensor broadcasting
    against ``y64`` (a per-phase term count)."""
    u = 2.0 ** -24
    eps_out = 2.0 ** -8 if out_dtype == torch.bfloat16 \
        else float(torch.finfo(out_dtype).eps)
    n1 = torch.as_tensor(n_terms, dtype=torch.float64,
                         device=y64.device) + 1
    gamma = n1 * u / (1 - n1 * u)
    return gamma * amax64 + eps_out * y64.abs() \
        + float(np.finfo(np.float32).tiny)
