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


def naive_conv_transpose2d_pre(x: torch.Tensor, w_flat: torch.Tensor,
                               kernel_hw: Pair, *, strides: Pair,
                               padding: Sequence[Pair]) -> torch.Tensor:
    """The naive engine with the weight pre-reshaped offline to
    (R*S*C, N): the fair baseline against the engine's precomputed path.
    ``padding`` is non-negative, as in the reference."""
    xp = pad_or_crop(zero_insert(x, strides), padding)
    buf = im2col(xp, kernel_hw, (1, 1))
    with ieee_fp32():
        return torch.matmul(buf, w_flat).to(x.dtype)


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


# ---------------------------------------------------------------------------
# Analytic memory-traffic model (paper Fig. 8), the reference's integer
# arithmetic line for line: bytes moved to and from main memory by each
# algorithm, with a cold cache and perfect reuse inside one GEMM tile.
# ---------------------------------------------------------------------------

def bytes_naive_transpose(b, h, w, c, r, s, n, stride, itemsize=4):
    sh = sw = stride
    hd, wd = (h - 1) * sh + 1, (w - 1) * sw + 1         # zero-inserted size
    oh, ow = hd + (r - 1), wd + (s - 1)                  # 'full'-ish pad
    read_x = b * h * w * c
    write_xhat = b * hd * wd * c                         # materialize x_hat
    read_xhat_patches = b * oh * ow * r * s * c          # im2col reads
    write_im2col = b * oh * ow * r * s * c               # im2col buffer
    read_im2col = b * oh * ow * r * s * c                # GEMM streams buffer
    read_k = r * s * c * n
    write_y = b * oh * ow * n
    return itemsize * (read_x + write_xhat + read_xhat_patches + write_im2col
                       + read_im2col + read_k + write_y)


def bytes_huge_transpose(b, h, w, c, r, s, n, stride, itemsize=4):
    """Each of the s² phases reads the plane once per tap of its
    sub-kernel: R·S/s² tap reads of every input pixel in all."""
    sh = sw = stride
    oh, ow = (h - 1) * sh + r, (w - 1) * sw + s
    read_x_taps = b * h * w * c * (r * s) / (sh * sw)
    read_k = r * s * c * n
    write_y = b * oh * ow * n
    return itemsize * (read_x_taps + read_k + write_y + b * h * w * c)


def memory_reduction_transpose(b, h, w, c, r, s, n, stride, itemsize=4):
    base = bytes_naive_transpose(b, h, w, c, r, s, n, stride, itemsize)
    huge = bytes_huge_transpose(b, h, w, c, r, s, n, stride, itemsize)
    return dict(naive_bytes=base, huge_bytes=huge, reduction=1.0 - huge / base)


def bytes_naive_dilated(b, h, w, c, r, s, n, out_hw, dilation, itemsize=4):
    """Traffic of the DarkNet dilated path: the zero-inserted kernel
    written once, then im2col at the dilated extent.  ``out_hw`` and
    ``dilation`` come from the plan, so stride and padding are folded in."""
    (dh, dw) = dilation
    rd, sd = (r - 1) * dh + 1, (s - 1) * dw + 1
    oh, ow = out_hw
    read_k = r * s * c * n
    write_kd = rd * sd * c * n                       # zero-inserted kernel
    read_x = b * h * w * c
    read_patches = b * oh * ow * rd * sd * c         # im2col reads
    write_im2col = b * oh * ow * rd * sd * c
    read_im2col = b * oh * ow * rd * sd * c          # GEMM streams buffer
    read_kd = rd * sd * c * n
    write_y = b * oh * ow * n
    return itemsize * (read_k + write_kd + read_x + read_patches
                       + write_im2col + read_im2col + read_kd + write_y)


def bytes_planned_single(plan, b=1, itemsize=4):
    """One planned 'conv'/'dilated' site from its ``ConvPlan``: ``naive``
    the zero-inserted kernel and the dilated im2col buffer; ``untangled``
    one padded plane written once, R·S tap reads of it, the superpack
    streamed once and the output written once."""
    spec = plan.spec
    h, w = spec.in_hw
    c, n = spec.in_c, spec.out_c
    r, s = spec.kernel_hw
    dil = spec.dilation if spec.kind == "dilated" else (1, 1)
    (ph, pw) = spec.padding
    oh, ow = plan.out_hw
    naive = bytes_naive_dilated(b, h, w, c, r, s, n, plan.out_hw, dil,
                                itemsize)
    hp, wp = h + ph[0] + ph[1], w + pw[0] + pw[1]
    untangled = b * h * w * c                        # read x
    untangled += b * hp * wp * c                     # single padded plane
    untangled += b * r * s * oh * ow * c             # tap reads of the plane
    untangled += r * s * c * n                       # superpack streams once
    untangled += b * oh * ow * n                     # output write
    untangled *= itemsize
    return dict(naive_bytes=naive, untangled_bytes=untangled,
                reduction=1.0 - untangled / naive)


def bytes_planned_transpose(plan, b=1, itemsize=4):
    """One planned transposed site from its ``ConvPlan``: ``per_phase``
    pads a copy of the plane per phase, reads its taps there and
    re-reads and re-writes the output to interleave it; ``fused`` writes
    one padded plane, reads it once, streams the superpack once and
    writes the output interleaved."""
    spec = plan.spec
    h, w = spec.in_hw
    c, n = spec.in_c, spec.out_c
    oh, ow = plan.out_hw
    read_x = b * h * w * c

    per_phase = read_x
    for ex in plan.phases:
        th, tw = ex.taps
        u, v = ex.out_hw
        if th * tw == 0 or u * v == 0:
            continue
        hp = h + max(0, ex.pad[0][0]) + max(0, ex.pad[0][1])
        wp = w + max(0, ex.pad[1][0]) + max(0, ex.pad[1][1])
        per_phase += b * hp * wp * c                 # phase's padded copy
        per_phase += b * th * tw * u * v * c         # tap-view reads
        per_phase += th * tw * c * n                 # phase weights
        per_phase += b * u * v * n                   # phase output write
    per_phase += 2 * b * oh * ow * n                 # interleave read+write

    (glh, ghh), (glw, ghw) = plan.gpad
    hg, wg = h + glh + ghh, w + glw + ghw
    fused = read_x
    fused += b * hg * wg * c                         # single padded plane
    fused += b * hg * wg * c                         # one residency, read once
    fused += plan.total_taps * c * n                 # superpack streams once
    fused += b * oh * ow * n                         # interleaved output write
    return dict(per_phase_bytes=itemsize * per_phase,
                fused_bytes=itemsize * fused)
