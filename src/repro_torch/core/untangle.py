"""Untangling (paper §3.2) helpers: padding with crops and output sizes.

Counterpart of ``repro.core.untangle``; only what the plans need is here
(the untangled correlation itself is ``ConvPlan.apply`` on a 'conv' or
'dilated' plan, or kernel B's ``untangled_conv2d``).
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
