"""Int8 weight quantization: the per-row scheme behind int8 superpacks.

Counterpart of the checkpoint / superpack half of ``repro.runtime.compress``
(``quantize_int8_rows`` / ``dequantize_int8``): ``ConvPlan.pack`` of a
``wdtype='int8'`` spec quantizes each row of the tap-major superpack here
(one f32 scale per ``(tap, c)`` row), and ``ConvPlan.unpack`` dequantizes
through the same primitives.  The codes and scales are bit-equal to the JAX
package's for the same f32 input.
"""
from __future__ import annotations

import numpy as np
import torch

# scale floor: keeps the divide finite for all-zero / subnormal rows.
# Applied AFTER the /127 so the floor is the smallest *normal* f32
_SCALE_FLOOR = float(np.finfo(np.float32).tiny)

# scale ceiling: f32max/127 rounds UP in f32, so the extreme code's
# dequant 127·scale would overflow to inf; nudge down until the product
# is finite (error stays far under one grid step at that magnitude)
_SCALE_MAX = np.float32(np.finfo(np.float32).max) / np.float32(127.0)
with np.errstate(over="ignore"):        # the probe overflow is the point
    while not np.isfinite(np.float32(127.0) * _SCALE_MAX):
        _SCALE_MAX = np.nextafter(_SCALE_MAX, np.float32(0.0))
_SCALE_MAX = float(_SCALE_MAX)


def quantize_int8_rows(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows, N) float -> (q int8 (rows, N), scale f32 (rows, 1)).

    Per-row symmetric scale ``scale[r] = max|w[r, :]| / 127``, floored and
    capped so all-zero, subnormal and ±f32max rows stay finite both ways
    through the grid; the per-element error is at most ``0.5·scale[r]``.
    Subnormal weights count as zero: XLA computes with subnormals flushed
    to zero on the CPU and on the TPU, so the JAX package's quantizing
    divide sees them as 0, and flushing them here keeps the codes
    bit-equal to its."""
    w = w.float()
    w = torch.where(w.abs() < _SCALE_FLOOR, torch.zeros_like(w), w)
    a = w.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(a / 127.0, _SCALE_FLOOR, _SCALE_MAX)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Shared dequant: ``q · scale`` in f32, one IEEE multiply per element;
    broadcasts a scalar (per-tensor) or (rows, 1) (per-row) scale."""
    return q.float() * scale
