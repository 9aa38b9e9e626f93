"""Untangling (paper §3.2) helpers: padding with crops and output sizes.

Counterpart of ``repro.core.untangle``: a stride-1, strided or dilated
correlation of x (B, H, W, C) with K (R, S, C, N) rewritten as a sum of
per-tap products over the raw input,

    y = sum_{m,n}  x[:, m*dh :: sh, n*dw :: sw, :]  @  K[m, n]   (C x N GEMM)

with no im2col buffer and no zero inserted in a dilated kernel.  This is
the plain PyTorch form; the planned sites run ``ConvPlan.apply``, whose
'cuda' route is kernel B.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

Pair = tuple[int, int]


def pad_or_crop(x: torch.Tensor, pads: Sequence[Pair]) -> torch.Tensor:
    """Zero-pad the H, W dims of an NHWC tensor; negative amounts crop."""
    (ph, pw) = pads
    h_lo = max(0, -ph[0]); h_hi = max(0, -ph[1])
    w_lo = max(0, -pw[0]); w_hi = max(0, -pw[1])
    if h_lo or h_hi or w_lo or w_hi:
        x = x[..., h_lo:x.shape[-3] - h_hi, w_lo:x.shape[-2] - w_hi, :]
    cfg = (0, 0, max(0, pw[0]), max(0, pw[1]), max(0, ph[0]), max(0, ph[1]))
    if any(cfg):
        x = F.pad(x, cfg)
    return x


def conv_out_size(in_size: int, k: int, stride: int, dilation: int,
                  pad: Pair) -> int:
    eff_k = (k - 1) * dilation + 1
    return (in_size + pad[0] + pad[1] - eff_k) // stride + 1


def untangled_conv2d(x: torch.Tensor, kernel: torch.Tensor, *,
                     strides: Pair = (1, 1),
                     padding: Sequence[Pair] = ((0, 0), (0, 0)),
                     rhs_dilation: Pair = (1, 1),
                     accum_dtype=torch.float32, out_dtype=None,
                     fuse_taps: bool | None = None) -> torch.Tensor:
    """Standard / strided / dilated correlation via per-tap GEMMs.

    x: (..., H, W, C) NHWC; kernel: (R, S, C, N) HWIO.  ``rhs_dilation``
    > 1 is the atrous conv without the zero-inserted kernel (paper
    §3.2.2).  ``fuse_taps`` concatenates the tap views along the
    contraction dim into ONE wide GEMM (still zero-free); the default
    fuses when the output has too few rows (``oh*ow <= 128``) to amortize
    a product per tap and there are more than two taps, as the
    reference's heuristic does."""
    r, s, c, n = kernel.shape
    if x.shape[-1] != c:
        raise ValueError(f"channel mismatch {x.shape[-1]} vs {c}")
    (sh, sw) = strides
    (dh, dw) = rhs_dilation
    x = pad_or_crop(x, padding)
    hp, wp = x.shape[-3], x.shape[-2]
    oh = (hp - (r - 1) * dh - 1) // sh + 1
    ow = (wp - (s - 1) * dw - 1) // sw + 1
    if oh <= 0 or ow <= 0:
        raise ValueError(f"non-positive output {oh}x{ow}")
    out_dtype = out_dtype or x.dtype
    if fuse_taps is None:
        fuse_taps = (oh * ow <= 128) and (r * s > 2)

    def tap_view(m, nn):
        return x[..., m * dh:m * dh + (oh - 1) * sh + 1:sh,
                 nn * dw:nn * dw + (ow - 1) * sw + 1:sw, :].to(accum_dtype)

    k = kernel.to(accum_dtype)
    if fuse_taps:
        buf = torch.cat([tap_view(m, nn) for m in range(r)
                         for nn in range(s)], dim=-1)
        return torch.matmul(buf, k.reshape(r * s * c, n)).to(out_dtype)
    acc = None
    for m in range(r):
        for nn in range(s):
            t = torch.matmul(tap_view(m, nn), k[m, nn])
            acc = t if acc is None else acc + t
    return acc.to(out_dtype)


def untangled_depthwise_conv1d(x: torch.Tensor, kernel: torch.Tensor, *,
                               causal: bool = True,
                               accum_dtype=torch.float32) -> torch.Tensor:
    """Depthwise temporal conv via the C = 1 "outer product" untangling
    (paper §3.2.3): a sum of shifted, per-channel-scaled copies.

    x: (..., T, C); kernel: (K, C).  ``causal`` pads K-1 steps in front;
    otherwise (K-1)//2 in front and K//2 behind."""
    k, _ = kernel.shape
    t = x.shape[-2]
    lo, hi = (k - 1, 0) if causal else ((k - 1) // 2, k // 2)
    xp = F.pad(x, (0, 0, lo, hi))
    acc = None
    for i in range(k):
        term = xp[..., i:i + t, :].to(accum_dtype) * kernel[i].to(accum_dtype)
        acc = term if acc is None else acc + term
    return acc.to(x.dtype)
