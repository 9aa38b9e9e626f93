"""Dense oracles for the hand-written kernels (a CPU and test oracle only).

Counterpart of ``repro.kernels.ref``: ``flash_attention_ref`` and
``untangled_conv2d_ref``, the library convolution as an oracle independent
of the untangled form.  The other convolution oracles live in
``core/reference.py``."""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.reference import ieee_fp32

Pair = tuple[int, int]

NEG_INF = -2.0 ** 30


def flash_attention_ref(q, k, v, *, causal=True, window=0, scale=None,
                        q_offset=0):
    """Dense-softmax oracle for kernel F.  q: (B, Sq, H, D); k, v:
    (B, Sk, Kh, D).  Computes in f32 (f64 for f64 inputs) and rounds to
    q's dtype.  ``q_offset`` (absent in JAX's, where it is 0) puts q[0] at
    that absolute position for the causal and window masks."""
    b, sq, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    scale = scale or d ** -0.5
    ct = torch.promote_types(q.dtype, torch.float32)
    qr = q.reshape(b, sq, kh, g, d).to(ct)
    s = torch.einsum("bqkgd,bskd->bkgqs", qr, k.to(ct)) * scale
    qpos = q_offset + torch.arange(sq, device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = torch.ones((sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window:
        mask &= qpos[:, None] - kpos[None, :] < window
    s = s.masked_fill(~mask, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", w, v.to(ct))
    return o.reshape(b, sq, h, d).to(q.dtype)


def untangled_conv2d_ref(x: torch.Tensor, kernel: torch.Tensor, *,
                         strides: Pair = (1, 1),
                         padding: Sequence[Pair] = ((0, 0), (0, 0)),
                         rhs_dilation: Pair = (1, 1)) -> torch.Tensor:
    """The library's conv as the oracle (NHWC ``x``, HWIO ``kernel``,
    correlation): negative pads crop, positive pads zero-fill, then
    ``F.conv2d`` in f32 with TF32 off, cast back to ``x``'s dtype."""
    (ph, pw) = padding
    h_lo, h_hi = max(0, -ph[0]), max(0, -ph[1])
    w_lo, w_hi = max(0, -pw[0]), max(0, -pw[1])
    x = x[..., h_lo:x.shape[-3] - h_hi, w_lo:x.shape[-2] - w_hi, :]
    lead = tuple(x.shape[:-3])
    x4 = x.reshape((-1,) + tuple(x.shape[-3:])).float()
    x4 = F.pad(x4, (0, 0, max(0, pw[0]), max(0, pw[1]),
                    max(0, ph[0]), max(0, ph[1])))
    with ieee_fp32():
        y = F.conv2d(x4.permute(0, 3, 1, 2),
                     kernel.float().permute(3, 2, 0, 1),
                     stride=tuple(strides), dilation=tuple(rhs_dilation))
    y = y.permute(0, 2, 3, 1)
    return y.reshape(lead + tuple(y.shape[1:])).to(x.dtype)
