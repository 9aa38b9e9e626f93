"""Int8 quantization primitives: gradient compression and the per-row
scheme behind int8 superpacks.

Counterpart of ``repro.runtime.compress``, both roles:

1. Error-feedback gradient compression (``quantize_int8``,
   ``init_error_state``, ``crosspod_allreduce_compressed``): gradients
   summed across pods ride as int8 codes (int32 on the wire, as JAX's)
   with a per-tensor scale, and the quantization residual is fed into the
   next step's gradient.  The pods share one scale, the largest of theirs,
   and each quantizes on it.  JAX's quantizes each pod on its own scale
   and multiplies the summed codes by the largest: wrong wherever the
   pods' scales differ (pods at 0.5 and 1.0 give 1.0 for a mean of 0.75);
   where they agree the two are equal.
2. The checkpoint / superpack half (``quantize_int8_rows`` /
   ``dequantize_int8``): ``ConvPlan.pack`` of a ``wdtype='int8'`` spec
   quantizes each row of the tap-major superpack here (one f32 scale per
   ``(tap, c)`` row), and ``ConvPlan.unpack`` dequantizes through the same
   primitives.

The codes and scales are bit-equal to the JAX package's for the same f32
input.
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


def _flush(x: torch.Tensor) -> torch.Tensor:
    """Subnormals as zero, as XLA computes on the CPU and the TPU."""
    return torch.where(x.abs() < _SCALE_FLOOR, torch.zeros_like(x), x)


def quantize_int8(g: torch.Tensor, err: torch.Tensor, scale=None):
    """g, err: f32 -> (q int8, scale f32 0-d, new_err): JAX's per-tensor
    symmetric scale with error feedback (``scale``: quantize on this one
    instead of the tensor's own).  ``new_err`` is the residual to carry
    into the next step's gradient."""
    gc = _flush(g.float() + err.float())
    if scale is None:
        scale = torch.clamp(gc.abs().amax() / 127.0, _SCALE_FLOOR,
                            _SCALE_MAX)
    q = torch.clamp(torch.round(gc / scale), -127, 127).to(torch.int8)
    return q, scale, _flush(gc - q.float() * scale)


def init_error_state(params):
    """Zero f32 residuals shaped like ``params`` (a tree of tensors)."""
    from repro_torch.train.tree import tree_map
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def crosspod_allreduce_compressed(grads, errs, dist, axis: str = "pod"):
    """The mean over ``axis`` of every gradient as int8 codes with error
    feedback: (mean grads, new residuals), each rank its pod's.  The scale
    is the largest of the pods' (a max all-reduce), every pod quantizes on
    it, the codes are summed as int32 and dequantized once."""
    from repro_torch.core import comm
    from repro_torch.train.tree import tree_leaves, tree_unflatten
    group = dist.group(axis)
    n = dist.extent(axis)
    out, new_e = [], []
    for g, e in zip(tree_leaves(grads), tree_leaves(errs)):
        gc = _flush(g.float() + e.float())
        own = torch.clamp(gc.abs().amax() / 127.0, _SCALE_FLOOR, _SCALE_MAX)
        scale = comm.all_reduce(own, group, kind="pod_scale_max", op="max")
        q, _, ne = quantize_int8(g, e, scale)
        summed = comm.all_reduce(q.to(torch.int32), group,
                                 kind="pod_all_reduce")
        out.append(summed.float() * scale / n)
        new_e.append(ne)
    return tree_unflatten(grads, out), tree_unflatten(errs, new_e)


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
